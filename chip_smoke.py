#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card   — name and power limit (as ``nvidia-smi`` gives them), versions;
2. build  — nvcc builds the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernel 1 (ODLHash projection, tensor cores) against its plain version on
   the card, including the generated alpha itself, on the route its plan
   takes (one pass, or K split over blocks at few rows); then the first 8
   rows of one x at B = 16,384 down to 1 must come out bit for bit by the
   plan's route, the one pass and a split of K;
4. the RLS update against its plain version on the card, through both
   routes: the single pass (kernels 2 and 3: the fleet entry and the
   one-head entry, the latter's plan and layout checked and a fully masked
   head exact) and the two-stage route; masked streams exact; then the
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
   single-pass RLS must have replayed at both widths (one RLS replay per
   tick; each trial's ``run_fleet`` replays a 16-tick CUDA graph 63 times,
   captured once per trial configuration, whose one-tick warm-up is the
   one eager RLS launch per capture).  Before it, the
   kernels are held against their plain versions at the path's own shapes
   (one stream a tick; the boot's and the accuracy sets' batches);
6. the fleet path: ``har_odl.full()`` at S=16,384 streams, ``train_phase``
   for 32 ticks and ``algo1`` for 96, through ``run_fleet`` (one CUDA graph
   of the whole run each; the first call's rate has its capture timed in,
   and the capture ms and a second, replay-only call's rate are printed
   apart); the graph replays show
   the path's kernels ran once a tick, and the accounting identities hold;
   then a small fleet run on the card and on the CPU must agree, and a
   profiler window shows where a tick's device time goes (the RLS update
   must be one kernel per tick there: an eager ``fleet_step`` loop); 6b
   also lists the CUDA kernels of one eager ``plan`` per mode, which must
   be the projection and the plan's pass and nothing else;
6r. ``run_fleet``'s chunk runner (one CUDA graph per chunk shape): (a)
   phase 6's two runs with ``chunk=16`` and a ragged ``chunk=40``, each
   bit for bit an eager ``fleet_step`` loop (final state and every
   output), the path's kernels replayed at least once a tick, one capture
   per (mode, chunk shape), the result in the caller's P with the default
   donation and the caller's state untouched with ``donate=False``, which
   replays the donating run's graph (no capture of its own); it
   prints graphed and eager stream·ticks/s, capture ms and a profiled
   replay window's device busy share; (b) one paper trial (S=1, N=128,
   1,008 ticks) through the runner, in the trial harness's 16-tick chunks
   and as one graph of all its ticks, each bit for bit the eager loop,
   with its capture and replay ms;
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
6l. the dense backbone's training path (``optim/adam.py``, ``models/model.py``
   ``train_step``/``odl_update``, ``launch/train.py``) at qwen3-4b's full
   width, after every earlier phase has freed its memory: (a) the
   ``TrainState`` built on the card from the seed (4,411,424,256 f32 params,
   m and v), the allocator's bytes before and after; (b)
   ``launch.train.train`` for 12 steps at B=32, S=64 with remat and the
   default ``TrainConfig`` (32 ODL rows a step: the head passes
   min_trained = 288 after step 9): every loss finite, every param slice
   moved, the head's count equal to the queried rows, per step
   ``odl_query_frac``, ``odl_theta`` and seconds, the steady s/step and
   tokens/s (host clock, synchronised), the allocator's peak and the model
   FLOPs as a share of the bf16 peak; the projection and the one-head RLS
   kernel must have launched; (c) at smoke width, two ``train_step``s from
   one state bit for bit, and 4 steps + resume to 8 bit for bit 8
   uninterrupted ones (params, moments, head, losses); (d) ``odl_update`` at
   n_in 2,560 from a head warmed on the CPU, one batch on the card and on the
   CPU: some rows prune, decisions, count and ``PruneState`` exact, P within
   2e-5 in units of I/ridge and beta within 2e-4; (e) mamba2-780m at full
   width (780,148,992 parameters) and (f) recurrentgemma-9b at 6 of its 38
   layers (3,410,120,704 parameters; reduced to fit f32 params, m, v and
   gradients on one card) each as (b), its launches counted from 0 around
   its run.  On (b), (e) and (f) the projection launches exactly twice and
   the one-head RLS once a step, no replays.  Every shape 6l launched a
   kernel at must be one phases 2-4 held;
6m. the MoE archs' serving path (``models/moe.py``, MLA in
   ``models/attention.py``), after 6l has freed its memory: (a)
   deepseek-moe-16b built on the card from the seed (16,879,568,896
   parameters), build seconds and the allocator's peak; (b) 256 streams
   prefilled with 15 tokens, then ``serve_step`` of token 16, at capacity
   factor E/k (no pair can drop at any token count) within atol 0.15, rtol
   0.05 of ``lm_hidden``'s logits over all 16, and the (token, choice) pairs
   the prefill and a decode step drop at the default 1.25; (c) two decodes of
   16 tokens from one prefill through ``_decode_feats``, bit for bit, and the
   decode ms per token; (d) 32 ticks of ``serve_step`` + ``serve_apply_labels``
   with a synchronous teacher (each launching the projection and the plan's
   pass once and, with an answer, the RLS pass once), then a profiler window
   of 8 more: backbone against head device ms and the busy share; (e)
   ``launch.serve.serve`` at B=256, 32 tokens, 2 tenants, reconciled; (f)
   deepseek-v2-236b at full width and 4 of its 60 layers (16,937,047,040
   parameters): (a)-(c) with the MLA latent cache, ``onehot`` and ``dus``;
   (g) a deepseek-v2-236b decode tenant (smoke width, B=256, 48 ticks) on two
   port workers, migrated after tick 16, bit for bit its solo run, with each
   worker's path kernels.  Every shape 6m launched a kernel at must be one
   phases 2-4 held;
6n. the SSD and hybrid RG-LRU archs' serving path (``models/ssm.py``,
   ``models/rglru.py``), after 6m has freed its memory, on mamba2-780m at
   full width and depth: (a) built on the card from the seed (780,148,992
   parameters), build seconds and the allocator's peak; (b) 256 streams
   prefilled with 15 tokens, then ``serve_step`` of token 16 against
   ``lm_hidden``'s logits over all 16, within atol 0.15, rtol 0.05 at unit
   scale (logits divided by sqrt(d) times the output matrix's rms: mamba2
   ties its std-1 embedding) at 2 layers, printed at all 48; (c) at B=2 a
   1,024-token prefill (8 chunks) and 16 decode steps fed the next tokens,
   against ``lm_hidden`` over 1,152 (9 chunks) at positions 1,024-1,039, the
   hidden states and the logits, with (b)'s bounds and depths; (d) two
   decodes of 16 tokens from one prefill through ``_decode_feats`` (one CUDA
   graph a step, two graphs reading the recurrent leaves in turns), bit for
   bit, the decode ms per token and the cache bytes; (e) 32 ticks of
   ``serve_step`` + ``serve_apply_labels`` as 6m (d), then 8 profiled; (f)
   ``launch.serve.serve`` at B=256, 32 tokens, 2 tenants, reconciled; (g)
   recurrentgemma-9b at full width and depth (10,444,771,328 parameters):
   (a)-(e), (b) bounded at one group (rec, rec, attn) and (c) a 2,040-token
   prefill with max_len 2,056 decoding 16 across its ring's slot 2,048,
   against ``lm_hidden`` over 2,056; (h) a recurrentgemma-9b decode tenant
   (smoke width, B=256, 48 ticks: the nested hybrid cache) on two port
   workers, migrated after tick 16, bit for bit its solo run, with each
   worker's path kernels.  Every shape 6n launched a kernel at must be one
   phases 2-4 held;
6o. whisper-small's encoder-decoder (``models/encdec.py``, cross-attention
   in ``models/attention.py``) at full width (12 encoder and 12 decoder
   layers, d_model 768, vocab 51,865), after 6n has freed its memory: (a)
   the serving params built on the card from the seed (263,864,064
   parameters), build seconds and the allocator's peak; (b)
   ``encdec_prefill`` of 64 streams of 1,500 stubbed frames (30 s of audio,
   the naive encoder) into a 448-slot self cache, then 32
   ``encdec.decode_step`` tokens: each decoded position's hidden against
   ``decode_train``'s teacher-forced hidden within atol 0.15, rtol 0.05 at 2
   encoder and decoder layers, printed at 12; the same decode from cloned
   caches bit for bit; prefill ms and peak, decode ms per token p50/p95
   (eager, host clock, synchronised) and a profiler window of 4 decode
   steps (device busy ms, device ops and the costliest kernels a step);
   (c) ``launch.train.train`` for 12 steps at B=32, S=64 (frames drawn as
   the reference's loop draws them) as 6l (b), then two ``train_step``s in
   a profiler window; (d) smoke width as 6l (c).  Every shape 6o launched
   a kernel at must be one phases 2-4 held;
6p. the MoE and MLA stacks' training path (``models/moe.py``'s backward,
   ``models/attention.py``'s MLA), expert parallelism and the model-side
   mesh, after 6o has freed its memory: (a) a deepseek-moe-16b TrainState
   on the card at full width and 4 of its 28 layers (2,770,880,512
   parameters; f32 params, m, v and gradients, 16 bytes a parameter), its
   build seconds and allocator bytes; (b) ``launch.train.train`` for 12
   steps at B=32, S=64 as 6l (b), with every step's aux loss finite and
   0.01 aux printed, then two ``train_step``s in a profiler window (the
   head's device ms, under ``train.head``, against the backbone's, and the
   busy share); (c) at smoke width, for both MoE archs, 6l (c); (d)
   deepseek-v2-236b at full width and 1 of its 60 layers (5,020,697,600
   parameters) with bf16 master params and f32 moments (12 bytes a
   parameter), (b) at B=8, S=64, its routed experts cut 160 -> 16 only if
   the estimate does not fit the card's free memory (printed); (e)
   ``moe_block_ep`` on a 2 x 4 (data, model) mesh of ``cuda:0`` entries,
   one deepseek-moe-16b layer at full width, x (8, 256, 2,048) f32 with
   TF32 off, at capacity factor E/k against the dense block within 1e-5 of
   max |y|, aux within 1e-6 of the token shards' mean (the reference's
   pmean) and within rtol 0.05 of the whole batch's; the pairs each token
   shard drops at the default 1.25; the EP and dense blocks' ms (one card,
   eight entries, exchanges device-local: not a multi-GPU time); two
   smoke-width ``train_step``s with ``moe_impl="ep"`` under the mesh
   against the meshless ones, losses and params within 1e-5; (f)
   ``pipeline_forward`` on an 8-entry ``("stage",)`` mesh against
   ``sequential_reference`` within 1e-5 at the reference test's shapes and
   at d 2,048; (g) deepseek-moe-16b smoke params ``reshard_tree``d onto a
   (4, 2) mesh, saved and ``rescale``d onto (2, 2), every shard bit for
   bit the slice its placement names.  In (b) and (d) the projection must
   launch twice and kernel 3 once a step; every shape 6p launched a kernel
   at must be one phases 2-4 held;
6q. the dry-run census (``launch/census.py``, ``launch/dryrun.py``), after
   6p has freed its memory: (a) 6l (b)'s qwen3-4b training step (f32
   master, remat, B=32, S=64) censused on a one-entry meta mesh and run
   once on a one-entry mesh of the card under the census (the allocator
   in expandable segments): the census's argument bytes against the
   allocator's for building the state and batch (as asked exactly, and in
   its 512-byte blocks within 512 bytes a leaf), arguments + the census's
   live peak within 10 % of the step's allocator peak, the card's census
   equal to meta's in FLOPs, bytes and exchanges, the census FLOPs over 6
   N tokens (remat's recompute); (b) the same for 6k's serve tick (B=256,
   128 slots, bf16 weights); (c) the EP block at 6p (e)'s shape and the
   pipeline at 6p (f)'s under a census: all-to-all and collective-permute
   counts and bytes equal to the analytic ones; (d) ``dryrun.run_cell``
   for one arch per family at every LM shape on the 16 x 16 meta mesh
   against the card's memory, one process a family (no card), started
   before 6p and run beside 6p, 6s and (a)-(c): one row per cell, status,
   peak, fits, flops_total and bytes_total; an error fails the phase.  Every
   shape 6q launched a kernel at must be one phases 2-4 held;
6s. the dense stacks' training step over partitioned leaves
   (``model.place_train_state``, ``model.partitioned_train_step``), after
   6p has freed its memory: qwen3-4b at full width and 4 of its 36 layers,
   B=32, S=64, f32 master params, remat, on a 2 x 4 (data, model) mesh of
   ``cuda:0`` entries: (a) two partitioned steps and two meshless ones from
   one seeded state, in f32 compute with TF32 off (loss and grad norm within
   1e-5 relative, every gathered param and moment within 1e-5 of its scale)
   and again in bf16 (the reference test's bounds: loss rtol 2e-2, leaves
   atol = rtol = 3e-2); (b) after each step every param and moment a
   ``Sharded`` on its ``abstract_train_state`` placement, each shard its
   slice's shape on its entry, and each position's bytes equal to the
   census's per-device argument bytes; (c) one more step under a census, its
   exchanges by kind, count and bytes equal to
   ``census.partitioned_train_exchanges``; (d) the projection launched twice
   and kernel 3 once a step, at shapes phases 2-4 held; (e) s/step of the
   partitioned and the meshless steps and each one's allocator peak (one
   card, eight entries: not a multi-GPU time);
6t. the DeepSeek stacks' training step over partitioned leaves, after 6s,
   on its 2 x 4 mesh of ``cuda:0`` entries, remat on: (a) deepseek-moe-16b
   at full width and 2 of its 28 layers, B=32, S=64, f32 state and compute
   (TF32 off), under moe_impl "dense" (two partitioned steps against two
   meshless ones, at the default capacity factor, where pairs drop) and
   "ep" (against the whole-tensor EP step under the mesh), from one seeded
   state, each step from the reference step's state before it: loss and
   grad norm within 1e-5 relative, every gathered param and moment within
   twice the reference step's own spread (the same step with its sums in
   another valid order against it: the meshless step at capacity factor
   E/k on the batch's rows reversed, and the step with the residual
   stream's basis, the heads and the experts' d_ff permuted; the larger),
   each step's kept pairs those of the step held to on every token before
   the first unclear one; (b) deepseek-v2-236b at full width and 1 of its 60
   layers, B=8, S=64, bf16 params and f32 moments, the meshless step first
   (its losses and the MLA and router leaves kept on the host), then the
   partitioned one: loss rtol 2e-2, those leaves within 3e-2 + 3e-2
   |meshless|; (c) after each step each position's bytes equal to the
   census's; (d) one more step of each deepseek-moe-16b mode under a
   census, its exchanges (``all-to-all`` included) equal to
   ``census.partitioned_train_exchanges``; (e) the projection launched twice
   and kernel 3 once a step; (f) s/step and allocator peak of each step
   beside its meshless or whole-tensor step's, and the phase's seconds;
7. times of each kernel and route, its plain version and its library
   yardstick, and its bound; the projection and the RLS update also at
   N=256 (S=16,384, P 4 GiB) and, with the plan's pass in ``serve``, at 6k's
   serving shape (256 streams, n_in 2,560); the projection and the one-head
   RLS update at 6l's training shape (32 rows of 2,560; k = 32), the
   projection at 6o (c)'s, 6l (e)-(f)'s and 6p (b), (d)'s (32 rows of 768,
   1,536, 4,096 and 2,048; 8 of 5,120) and the RLS update at 6p's (k = 32
   and 8); the projection and the plan's pass in ``serve`` at 6m's (256
   streams of n_in 2,048 and 5,120) and 6n's (n_in 1,536 and 4,096); the
   plan's pass in ``algo1`` (reads x) and ``train_phase`` (reads no x), in
   ``serve`` at n_in 8,192 (x read from device memory), and its reduced
   instances alone; the paper trials' one stream (the projection at n_in
   561 to N = 128 and 256, the fleet entry's RLS update at k = 1). Each
   projection row names its plan's grid and workspace bytes, and its bound
   counts the integer work of hashing alpha beside the TF32 products.

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
             (256, 2560, 128), (512, 2560, 128), (4, 64, 128), (32, 2560, 128), (8, 64, 128),
             (256, 2048, 128), (512, 2048, 128), (256, 5120, 128), (256, 64, 128),
             (256, 1536, 128), (512, 1536, 128), (256, 4096, 128), (512, 4096, 128),
             (32, 768, 128), (32, 1536, 128), (32, 4096, 128), (32, 2048, 128),
             (8, 5120, 128), (1, 561, 128), (1, 561, 256), (FLEET_STREAMS, 561, 256)]
K2_SHAPES = [(FLEET_STREAMS, 128, 1, 6), (512, 256, 1, 6), (1, 128, 16, 6),
             (4096, 128, 1, 6), (64, 64, 1, 6), (256, 64, 1, 6), (8192, 128, 1, 6),
             (12288, 128, 1, 6), (1024, 128, 1, 6), (2048, 128, 1, 6), (3072, 128, 1, 6),
             (512, 128, 1, 6), (256, 128, 1, 6), (1, 256, 1, 6), (FLEET_STREAMS, 256, 1, 6)]
# Phase 7 also times the projection and the RLS update at N=256 (the
# paper's Tables 2-3 width), at the fleet's S: the last shape of each list.
K1_N256, K2_N256 = K1_SHAPES[-1], K2_SHAPES[-1]
# Phase 4's check that a stream's P' and beta' at N=256 (the rank-1 cluster
# body) do not depend on S: the first streams of one fleet of 512 at each S.
ROW_STREAMS_N256 = (1, 33, 512)
# Phase 6k's serving shape (256 streams of qwen3-4b's d_model = 2,560; two
# fused tenants are 512 rows) and a smoke-width one (the card tests'), held
# by phases 2-4 and timed by phase 7; the plan's pass also at the widest
# dense d_model (chameleon-34b's 8,192), where x rows do not fit a stage.
K1_BACKBONE, K2_BACKBONE = (256, 2560, 128), (256, 128, 1, 6)
# Phase 6l's full-width training shape of the projection (B = 32 pooled rows
# of d_model 2,560), held by phase 2 and timed by phase 7 with K3_TRAIN.
K1_TRAIN = (32, 2560, 128)
# The training shapes of the projection on 6o (c), 6l (e)-(f) and 6p (b), (d):
# B = 32 pooled rows of whisper-small's d_model 768, mamba2-780m's 1,536,
# recurrentgemma-9b's 4,096 and deepseek-moe-16b's 2,048, and B = 8 of
# deepseek-v2-236b's 5,120, held by phase 2 and timed by phase 7; and of the
# one-head RLS update on 6p (k = B rows), held by phase 4 and timed by
# phase 7.
K1_FAMILY_TRAIN = {"encdec_train": (32, 768, 128), "ssm_train": (32, 1536, 128),
                   "hybrid_train": (32, 4096, 128), "moe_train": (32, 2048, 128),
                   "mla_train": (8, 5120, 128)}
K3_FAMILY_TRAIN = {"moe_train": (1, 128, 32, 6), "mla_train": (1, 128, 8, 6)}
PLAN_BACKBONE, PLAN_WIDE = (256, 128, 6, 2560), (256, 128, 6, 8192)
# Phase 6m's serving shapes (256 streams of deepseek-moe-16b's d_model 2,048,
# two fused tenants 512 rows; 256 of deepseek-v2-236b's 5,120, and of its
# smoke width's 64 on 6m's workers), held by phases 2-4; phase 7 times the
# two full-width ones.
K1_MOE, K1_MLA = (256, 2048, 128), (256, 5120, 128)
PLAN_MOE, PLAN_MLA = (256, 128, 6, 2048), (256, 128, 6, 5120)
# Phase 6n's serving shapes (256 streams of mamba2-780m's d_model 1,536 and
# of recurrentgemma-9b's 4,096; two fused tenants 512 rows), held by phases
# 2-4; phase 7 times the 256-stream ones.
K1_SSM, K1_HYBRID = (256, 1536, 128), (256, 4096, 128)
PLAN_SSM, PLAN_HYBRID = (256, 128, 6, 1536), (256, 128, 6, 4096)
# Phase 5b, the paper's tables on the card: one trial per drift row (the
# reference runs 3 for Table 2 and Fig 4, 5 for Table 3 and Fig 3), so 18
# trials of 1008 one-stream ticks; two of them run on the CPU as well.
PAPER_TRIALS = 1
PAPER_CROSS = (("hash", 256), ("base", 128))
PAPER_WIDTHS = (128, 256)
PAPER_KERNELS = ("xorshift_projection", "oselm_rls_update_fleet", "plan_rows")
# Shapes the single pass does not take go to the two-stage route; and
# streams spread over clusters of four (k >= 32) walked by fewer clusters
# than streams, at N = 128 and 256.
K2_EXTRA_SHAPES = [(64, 384, 1, 6), (4, 64, 64, 3), (64, 128, 32, 6), (3, 128, 64, 6),
                   (2, 256, 32, 6)]
# The one-head entry (kernel 3), (1, N, k, m): the first is the one phase 7
# times; phase 6l's training path (k = B rows a step: 32 at full width, 8 at
# smoke width) launches at the others, and 6l fails on a shape not here.
K3_SHAPES = [(1, 128, 16, 6), (1, 128, 32, 6), (1, 128, 8, 6)]
K3_TRAIN = (1, 128, 32, 6)
TWO_STAGE_SHAPE = (64, 384, 1, 6)
# The paper's S = 1 trials (5b): the projection of one stream at N = 128
# and 256 and the fleet entry's RLS update of one stream, timed by phase 7.
PAPER_K1 = {"paper_trial": (1, 561, 128), "paper_trial_n256": (1, 561, 256)}
PAPER_K2 = {"paper_trial": (1, 128, 1, 6), "paper_trial_n256": (1, 256, 1, 6)}
# Phase 3's check that a row's H does not depend on B or on the route: the
# first 8 rows of one x at each of these B, at each width.
ROW_BATCHES = (FLEET_STREAMS, 4096, 512, 256, 32, 8, 1)
ROW_WIDTHS = (561, 2560, 5120)
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
               (8, 128, 6, 7168), (8, 128, 6, 8192), (256, 128, 6, 8192),
               (256, 128, 6, 2048), (512, 128, 6, 2048), (256, 128, 6, 5120), (256, 128, 6, 64),
               (256, 128, 6, 1536), (512, 128, 6, 1536), (256, 128, 6, 4096),
               (512, 128, 6, 4096)]
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
# Phase 6m, the MoE archs' serving path: deepseek-moe-16b at full width and
# depth (16,879,568,896 parameters, 33.76 GB in bf16; the KV cache of 256
# streams over 128 slots 7.5 GB): (b)-(d) at ``batch`` streams, decode
# against prefill at capacity factor E/k (no pair can drop at any token
# count), bounded at ``bound_depth`` layers and printed at full depth, and
# the drops at the default 1.25 printed; (c) ``replay_ticks``
# decoded twice; (d) ``cascade_ticks``, then ``profile_ticks`` profiled; (e)
# ``serve`` at ``serve_tokens``, two tenants.  (f) deepseek-v2-236b at full
# width and ``mla_layers`` of its 60 layers (``mla_params``; all 60 are 479
# GB in bf16): (a)-(c), (c) with ``dus`` too.  (g) a ``worker_ticks``
# deepseek-v2-236b decode tenant at smoke width (each worker builds its own
# backbone: two full-width copies do not fit) moved between two workers past
# tick ``worker_cut``.
MOE = dict(arch="deepseek-moe-16b", variant="full", params=16_879_568_896, batch=256, max_len=128,
           prompt_len=16, bound_depth=2, replay_ticks=16, cascade_ticks=32, profile_ticks=8, serve_tokens=32,
           mla_arch="deepseek-v2-236b", mla_layers=4, mla_params=16_937_047_040,
           worker_variant="smoke", worker_ticks=48, worker_cut=16)
# Phase 6n, the SSD and hybrid archs' serving path at full width and depth:
# mamba2-780m (780,148,992 parameters, 1.56 GB in bf16; the f32 SSM state of
# 256 streams is 19.33 GB over its 48 layers) and recurrentgemma-9b
# (10,444,771,328, 20.89 GB; 12 (rec, rec, attn) groups and a (rec, rec)
# tail, its local attention on a ring of min(max_len, 2,048) slots): (b) at
# ``batch`` streams and (c) over a ``long_prompt``-token prompt at B=2 (mamba2
# 8 chunks of 128, recurrentgemma past its ring's 2,048 slots), each bounded
# at ``bound_depth`` layers (mamba2 the reference's 2-layer smoke depth,
# recurrentgemma one group) and printed at full depth; (d) ``replay_ticks``
# decoded twice; (e) ``cascade_ticks``, then ``profile_ticks`` profiled; (f)
# mamba2's ``serve`` at ``serve_tokens``; (h) a ``worker_ticks``
# recurrentgemma-9b decode tenant at smoke width moved between two workers
# past tick ``worker_cut``.
RECURRENT = {"batch": 256, "max_len": 128, "prompt_len": 16, "replay_ticks": 16,
             "cascade_ticks": 32, "profile_ticks": 8, "serve_tokens": 32, "worker_ticks": 48,
             "worker_cut": 16,
             "mamba2-780m": dict(params=780_148_992, bound_depth=2, long_prompt=1024,
                                 long_decode=16, long_forward=1152, long_max_len=1040),
             "recurrentgemma-9b": dict(params=10_444_771_328, bound_depth=3, long_prompt=2040,
                                       long_decode=16, long_forward=2056, long_max_len=2056)}
# Phase 6l, the dense backbone's training path at qwen3-4b's full width (12
# bytes a parameter for params, m and v, 4 more for the gradients): (b)
# ``launch.train.train`` for ``steps`` at ``batch`` x ``seq`` (``batch`` ODL
# rows a step: the head passes min_trained = 288 after step 9); (c) at smoke
# width ``smoke_batch`` x ``smoke_seq``, two steps from one state and
# ``resume_at`` steps + resume against 2 ``resume_at`` uninterrupted; (d) a
# head warmed on the CPU by ``warm_calls`` updates of ``batch`` rows.
TRAIN = dict(arch="qwen3-4b", variant="full", params=4_411_424_256, batch=32, seq=64, steps=12,
             smoke_batch=8, smoke_seq=32, resume_at=4, warm_calls=12)
# Phase 6l (e)-(f): the SSD stack at full width and the hybrid stack cut to
# its first 2 of 12 pattern groups (6 of 38 layers) to fit params, m, v and
# gradients (16 bytes a parameter) on one card; their parameter counts.
TRAIN_FAMILIES = {"mamba2-780m": dict(tag="(e)", params=780_148_992, depth=None),
                  "recurrentgemma-9b": dict(tag="(f)", params=3_410_120_704, depth=6)}
# Phase 6o, whisper-small's encoder-decoder at full width: (b) ``batch``
# streams of 30 s of audio (``frames`` encoder frames), ``decode`` tokens
# into a ``max_len`` self cache (Whisper's decoder context), decode against
# ``decode_train`` bounded at ``bound_depth`` encoder and decoder layers;
# (c)-(d) train as 6l (b)-(c).
ENCDEC = dict(arch="whisper-small", variant="full", params=263_864_064, batch=64, frames=1500,
              max_len=448, decode=32, bound_depth=2)
# Phase 6p, the MoE and MLA stacks' training path: each arch at full width
# and ``depth`` layers with ``param_dtype`` master params (deepseek-v2-236b's
# bf16 is the reference TrainConfig's note for it), 6l (b) at ``batch`` x
# ``seq``; deepseek-v2-236b's routed experts cut to ``experts_cut`` only if
# its state's estimate does not fit the card's free memory.
MOE_TRAIN = {
    "deepseek-moe-16b": dict(tag="(b)", depth=4, params=2_770_880_512, batch=32, seq=64,
                             param_dtype="float32"),
    "deepseek-v2-236b": dict(tag="(d)", depth=1, params=5_020_697_600, batch=8, seq=64,
                             param_dtype="bfloat16", experts_cut=16),
}
# 6p (e): the EP block on a (data, model) mesh of one card's entries, one
# deepseek-moe-16b layer at full width on x of ``x`` (B, S); smoke-width
# steps at ``smoke_batch`` x ``smoke_seq``.  (f): the pipeline at the
# reference test's shapes (8 stages, 4 microbatches of 2 rows, d 16) and at
# d 2,048.  (g): the rescale from one dev mesh to another.
EP = dict(mesh=(2, 4), x=(8, 256), smoke_batch=8, smoke_seq=32)
PIPE = dict(stages=8, microbatches=4, batch=2, widths=(16, 2048))
RESCALE = dict(arch="deepseek-moe-16b", meshes=((4, 2), (2, 2)))
# 6q: the dry-run census.  (a) 6l (b)'s training step (TRAIN: B=32, S=64,
# f32 master params, remat) and (b) 6k's serve tick (BACKBONE: B=256, 128
# slots, bf16 weights: the dry-run's ``w16`` decode cell), each censused on
# meta and run on a one-entry mesh of the card: the argument bytes within
# ``leaf_bytes`` of the allocator's a leaf (its 512-byte blocks), the
# census's arguments + live peak within ``peak_rtol`` of the step's
# allocator peak, the census on the card equal to the one on meta.  (c) the
# EP block at EP's shape and the pipeline at PIPE's, their exchanges
# against the analytic count.  (d) ``dryrun.run_cell`` for one arch per
# family at every LM shape on the 16 x 16 meta mesh, one process a family
# (no card), started before 6p and run side by side with 6p, 6s and (a)-(c):
# the sweep is host-bound (mamba2-780m's train_4k cell alone takes 82-102 s
# on the host of an H100 machine).
CENSUS = dict(leaf_bytes=512, peak_rtol=0.10,
              families=("qwen3-4b", "deepseek-moe-16b", "mamba2-780m", "recurrentgemma-9b",
                        "chameleon-34b", "whisper-small"))
# Phase 6s, the dense stacks' training step over partitioned leaves: qwen3-4b
# at full width cut to ``depth`` of its 36 layers (so that two f32 training
# states fit the card), 6l (b)'s B x S, on a ``mesh`` of cuda:0 entries;
# ``steps`` partitioned and meshless steps from one seeded state in f32
# compute (TF32 off) and again in bf16, then one more under a census.
PARTITIONED = dict(arch="qwen3-4b", depth=4, batch=32, seq=64, mesh=(2, 4), steps=2)
# Phase 6t, the DeepSeek stacks' training step over partitioned leaves, on
# 6s's mesh: (a) deepseek-moe-16b at full width and ``depth`` of its 28
# layers, f32 state and compute (TF32 off), under moe_impl "dense" and "ep";
# (b) deepseek-v2-236b at full width and 1 of its 60 layers, bf16 params and
# f32 moments, bf16 compute (6p (d)'s state).
PARTITIONED_MOE = dict(mesh=(2, 4), steps=2,
                       moe=dict(arch="deepseek-moe-16b", depth=2, batch=32, seq=64),
                       mla=dict(arch="deepseek-v2-236b", depth=1, batch=8, seq=64))
# The kernels the training path launches every step.
TRAIN_KERNELS = ("xorshift_projection", "oselm_rls_update")
COUNTERS = ("ticks", "stream_steps", "tickets_issued", "queries_issued", "labels_applied",
            "tickets_dropped", "queries_dropped", "replies_orphaned", "tickets_lost",
            "queries_lost", "tickets_coalesced", "queries_coalesced", "asks_deferred",
            "tickets_reasked")
ACTIVATIONS = ("sigmoid", "relu", "tanh", "identity")

# NVIDIA H100 SXM data sheet, dense, at 700 W: f32 outside the tensor cores,
# TF32 on them, and HBM3 bandwidth.  The int32 rate is not on the sheet: the
# f32 rate counts an FMA as two on 128 lanes an SM, and a Hopper SM has 64
# int32 lanes, so 67e12 / 4.
PEAK_F32_FLOPS = 67e12
PEAK_INT32_OPS = 67e12 / 4
# Integer operations of the projection's hash a value of alpha: the two-wide
# mix16x2 does three rounds of three shift-and-xors and a masked multiply,
# ten operations a round, for two values at once.
HASH_OPS_PER_ALPHA = 15
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
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
    from repro_torch.kernels import ops, ref, xorshift_proj

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
    # A row's H is the same bit for bit whatever B is and whichever route
    # its shape takes: the first 8 rows of one x at every ROW_BATCHES entry,
    # by the plan's route, by the one pass and by a split of K.
    routes = {}
    for n_in in ROW_WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(max(ROW_BATCHES), n_in, generator=g, device=device).to(dtype)
            want = None
            for b in ROW_BATCHES:
                plans = {xorshift_proj.projection_plan(b, n_in, 128, split_max_blocks=smb)
                         for smb in (xorshift_proj.SPLIT_MAX_BLOCKS, 0, 10 ** 6)}
                for plan in plans:
                    got = xorshift_proj.xorshift_projection(x[:b].contiguous(), 0x2D2A, 128,
                                                            plan=plan)[:8]
                    want = got if want is None else want
                    check(torch.equal(got, want[:b]),
                          f"projection rows at B={b}, n_in={n_in}, {dtype}, grid {plan.grid}: "
                          f"not bit for bit the rows at B={ROW_BATCHES[0]}")
                    routes.setdefault(n_in, set()).add("split" if plan.split else "one pass")
            del x
    print(f"kernel 1 rows: the first 8 rows of one x bit for bit at B = {ROW_BATCHES} "
          f"(f32 and bf16), by route: {{n_in: routes}} {routes}")
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
    # A stream's rows at N=256 are bit for bit the same at any S (cohort ==
    # solo and sharded == single device rest on it).
    P, beta, H, Y = _rls_inputs(max(ROW_STREAMS_N256), 256, 1, 6, device, SEED + 31)
    p_all, b_all = ops.oselm_rls_update_fleet(P, beta, H, Y)
    for s in ROW_STREAMS_N256:
        p_s, b_s = ops.oselm_rls_update_fleet(*(t[:s].contiguous() for t in (P, beta, H, Y)))
        check(torch.equal(p_s, p_all[:s]) and torch.equal(b_s, b_all[:s]),
              f"rls N=256: the first {s} streams differ from the same streams of "
              f"{max(ROW_STREAMS_N256)}")
    print(f"kernel 2 RLS update N=256 k=1 m=6 plan={oselm_update.single_pass_plan(256, 1, 6)}: "
          f"a stream's rows bit for bit at S = {', '.join(map(str, ROW_STREAMS_N256))}")
    del P, beta, H, Y, p_all, b_all
    # Kernel 3: the one-head entry (S = 1, k up to 64), at each K3_SHAPES
    # entry (phase 6l's training steps among them).
    errs["oselm_rls_update"] = 0.0
    for _, n, k, m in K3_SHAPES:
        P, beta, H, Y = (a[0] for a in _rls_inputs(1, n, k, m, device, SEED + 3 + k))
        check(ops.rls_route(n, k, m) == "single", f"one head N={n} k={k}: not a single pass")
        plan = oselm_update.single_pass_plan(n, k, m)
        check(oselm_update.kernel_smem_bytes(n, k, m, *plan)
              == oselm_update.single_pass_smem_bytes(n, k, m, *plan),
              f"one head N={n} k={k}: the dispatch and the kernel disagree on shared memory")
        zero_h, zero_y = torch.zeros_like(H), torch.zeros_like(Y)
        p_same, b_same = ops.oselm_rls_update(P, beta, zero_h, zero_y)
        check(torch.equal(p_same, P) and torch.equal(b_same, beta),
              f"one head N={n} k={k}: a masked update changed the head")
        before = ops.launch_counts["oselm_rls_update"]
        p_got, b_got = ops.oselm_rls_update(P, beta, H, Y)
        check(ops.launch_counts["oselm_rls_update"] == before + 1,
              "rls one head: kernel not launched")
        p_want, b_want = (a[0] for a in ref.rls_update_ref(P[None], beta[None], H[None], Y[None]))
        ep = (p_got - p_want).abs().max().item()
        eb = (b_got - b_want).abs().max().item()
        check(ep <= 2e-5 and eb <= 2e-4, f"rls one head N={n} k={k}: P err {ep}, beta err {eb}")
        print(f"kernel 3 oselm_rls_update N={n} k={k} m={m} plan={plan}: P |err| {ep:.3e}, "
              f"beta |err| {eb:.3e}, masked head exact")
        errs["oselm_rls_update"] = max(errs["oselm_rls_update"], ep, eb)
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
    from repro_torch.engine import graphs
    from repro_torch.kernels import ops

    splits = har.generate(seed=0)
    ox, _, _, tx = har.odl_split(splits, 0.6, 0)
    n_ticks = len(ox)
    errs = _paper_kernels_vs_plain(
        sorted({1, len(splits.train_x), len(splits.test0_x), len(tx)}), device)
    trial = common.drift_trial
    runs: dict[tuple, list] = {}  # (variant, N, theta) -> results, in call order
    # Eager launches (the accuracy sets' projections, each graph's one-tick
    # warm-up) and graph replays (the 1008 ticks of a trial's run_fleet).
    per_n = {n: dict.fromkeys(ops.launch_counts, 0) for n in PAPER_WIDTHS}
    per_n_replays = {n: dict.fromkeys(ops.launch_counts, 0) for n in PAPER_WIDTHS}
    captures = dict.fromkeys(PAPER_WIDTHS, 0)
    capture_ms = []
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
        before_replays = dict(graphs.kernel_replays)
        before_captures = graphs.capture_counts.get("chunk_runner", 0)
        before_ms = graphs.capture_ms.get("chunk_runner", 0.0)
        t0 = time.perf_counter()
        r = trial(run_seed, theta, n_hidden, variant, dataset_seed, device)
        trial_secs.append(time.perf_counter() - t0)
        for k, v in ops.launch_counts.items():
            per_n[n_hidden][k] += v - before[k]
            per_n_replays[n_hidden][k] += graphs.kernel_replays[k] - before_replays[k]
        new_captures = graphs.capture_counts.get("chunk_runner", 0) - before_captures
        captures[n_hidden] += new_captures
        if new_captures:
            capture_ms.append(graphs.capture_ms["chunk_runner"] - before_ms)
        runs.setdefault((variant, n_hidden, theta), []).append(r)
        done.setdefault(key, r)
        return dict(r)

    t_start = time.perf_counter()
    ops.reset_launch_counts()
    graphs.reset_replay_counts()
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
    replays = dict(graphs.kernel_replays)
    secs = time.perf_counter() - t_start
    print(f"paper tables on {device} ({PAPER_TRIALS} trial per drift row, {len(trial_secs)} "
          f"trials of {n_ticks} ticks run and {len(served)} repeats served from them, "
          f"{secs:.1f} s; a trial {min(trial_secs):.2f}-{max(trial_secs):.2f} s, of it the "
          f"run_fleet graph's capture {min(capture_ms):.1f}-{max(capture_ms):.1f} ms, "
          f"{sum(captures.values())} captures in all):")
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

    # The paper path went through the kernels at both widths: one replay
    # per tick, and one eager launch per capture (its one-tick warm-up).
    for n in PAPER_WIDTHS:
        for name in PAPER_KERNELS:
            check(per_n_replays[n][name] > 0, f"paper path N={n}: {name} never replayed")
        n_rls = sum(r["queries"] + r["skips"] for (_, w, _), rs in runs.items() if w == n
                    for r in rs)
        check(per_n_replays[n]["oselm_rls_update_fleet"] == n_rls,
              f"paper path N={n}: {per_n_replays[n]['oselm_rls_update_fleet']} RLS replays, "
              f"not one per tick ({n_rls})")
        check(per_n[n]["oselm_rls_update_fleet"] == captures[n],
              f"paper path N={n}: {per_n[n]['oselm_rls_update_fleet']} eager RLS launches, "
              f"not one per capture ({captures[n]})")
        check(per_n[n]["rls_two_stage"] + per_n_replays[n]["rls_two_stage"] == 0,
              f"paper path N={n}: two-stage route taken")
    print(f"  launches by width: {json.dumps(per_n)}; replays by width: "
          f"{json.dumps(per_n_replays)}; captures by width: {json.dumps(captures)}; kernels vs "
          f"plain at the path's shapes: {json.dumps(errs)}")
    return dict(launches=launches, replays=replays, errs=errs, captures=captures,
                capture_ms=capture_ms, trial_secs=trial_secs)


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


def _run_fleet_once(cfg, xs, ys, mode, device, **kw):
    """One ``run_fleet`` from a fresh fleet, its accounting checked: (state,
    outputs, seconds, launches + graph replays by kernel, replays alone).
    On the card ``run_fleet`` replays a CUDA graph per chunk, whose kernels
    raise ``graphs.kernel_replays``, not ``ops.launch_counts`` (there only
    the warm-up before a capture launches)."""
    import torch

    from repro_torch import engine
    from repro_torch.engine import graphs
    from repro_torch.kernels import ops

    n_ticks, n_streams = ys.shape
    state = engine.init_fleet(cfg, n_streams, device)
    _sync(device)
    ops.reset_launch_counts()
    graphs.reset_replay_counts()
    t0 = time.perf_counter()
    state, outs = engine.run_fleet(state, xs, ys, cfg, mode=mode, **kw)
    _sync(device)
    secs = time.perf_counter() - t0
    replays = dict(graphs.kernel_replays)
    counts = {k: n + replays[k] for k, n in ops.launch_counts.items()}
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
    return state, outs, secs, counts, replays


def phase_fleet(device="cuda", n_streams=FLEET_STREAMS, n_hidden=128,
                train_ticks=TRAIN_TICKS, algo1_ticks=ALGO1_TICKS):
    """``har_odl.full()`` fleet through ``run_fleet`` in two modes."""
    import torch

    from repro_torch.configs import har_odl
    from repro_torch.data import har

    from repro_torch.engine import fleet, graphs

    cfg = har_odl.full(n_hidden=n_hidden)
    data = har.generate(seed=SEED)
    res = {"launches": {}, "replays": {}}
    runs = {}
    for mode, n_ticks, shift_at in _fleet_modes(train_ticks, algo1_ticks):
        xs, ys = _fleet_ticks(data, n_ticks, n_streams, shift_at, device, SEED + n_ticks)
        state, outs, secs, counts, replays = _run_fleet_once(cfg, xs, ys, mode, device)
        runs[mode] = (state, outs)
        # The first call captures the run's graph (``_run_fleet_once`` zeroes
        # the tallies before it): its capture and a second, replay-only call
        # are read apart.
        res[f"{mode}_capture_ms"] = graphs.capture_ms.get("chunk_runner", 0.0)
        res[f"{mode}_replay_stream_ticks_per_s"] = (
            n_streams * n_ticks / _run_fleet_once(cfg, xs, ys, mode, device)[2])
        for name, n in counts.items():
            if device == "cuda" and name in MODE_KERNELS[mode]:
                check(replays[name] >= n_ticks,
                      f"{mode}: {name} replayed {replays[name]} < {n_ticks} times")
            res["launches"][name] = res["launches"].get(name, 0) + n
            res["replays"][name] = res["replays"].get(name, 0) + replays[name]
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
    fleet.release_chunk_graphs()  # the graphs' buffers
    print(f"fleet path (S={n_streams}, N={n_hidden}; one graph a run: *_stream_ticks_per_s "
          f"its first call, capture included, *_capture_ms and *_replay_stream_ticks_per_s "
          f"apart): {json.dumps(res)}")
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
    from repro_torch.engine import fleet

    cfg = har_odl.full()
    data = har.generate(seed=SEED)
    xs, ys = _fleet_ticks(data, n_ticks, n_streams, n_ticks, "cpu", SEED + 1)
    out = {}
    for device in ("cuda", "cpu"):
        state, outs = _run_fleet_once(cfg, xs.to(device), ys.to(device), "train_phase", device)[:2]
        out[device] = (state.elm.beta.cpu(), state.elm.P.cpu(), outs)
    fleet.release_chunk_graphs()
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
    warm-up run of the same shape that takes the first launches (the
    graph's capture, where ``run_fleet`` replays one), the allocator's
    growth and the library handles out of the timing."""
    from repro_torch.configs import har_odl
    from repro_torch.data import har

    cfg = har_odl.full()
    xs, ys = _fleet_ticks(har.generate(seed=SEED), n_ticks, n_streams, n_ticks, device,
                          SEED + n_ticks)
    _run_fleet_once(cfg, xs, ys, "train_phase", device)  # captures the run's graph
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
    after a warm-up call: ({call: {kernel: launches}}, profiles taken again
    for a dropped kernel event)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import engine
    from repro_torch.configs import har_odl
    from repro_torch.data import har
    from repro_torch.engine import fleet
    from repro_torch.kernels import ops

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
    # A profile that lists no kernel of a wrapper whose own count rose in it
    # dropped an event (seen once on an H100: an eager serve plan listed the
    # pass alone): it is taken again, up to twice; the kernels it lists are
    # held unchanged.
    tags = {"xorshift_projection": "proj_kernel", "plan_rows": "plan_rows_kernel",
            "readout": "plan_rows_kernel", "row_abs_mean": "plan_rows_kernel",
            "oselm_rls_update_fleet": "rls_", "oselm_rls_update": "rls_", "rls_two_stage": "rls_"}
    out, retaken = {}, 0
    for name, call in calls.items():
        call()
        _sync(device)
        for attempt in range(3):
            before = dict(ops.launch_counts)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call()
                _sync(device)
            out[name] = {e.key: e.count for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA and e.count > 0}
            launched = [k for k, n in ops.launch_counts.items() if n > before.get(k, 0)]
            if all(any(tags[k] in key for key in out[name]) for k in launched):
                break
            retaken += 1
    return out, retaken


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
    plan_kernels, retaken = _plan_kernels(device, n_streams)
    learn_kernels = plan_kernels.pop("learn")
    for mode, kernels in plan_kernels.items():
        check(sorted(kernels.values()) == [1, 1]
              and any("proj_kernel" in k for k in kernels)
              and any("plan_rows_kernel" in k for k in kernels),
              f"profile: an eager plan ({mode}) launched {kernels}, not the projection and the "
              "plan's pass alone")
    shown = {c: {k[:70]: n for k, n in ks.items()} for c, ks in plan_kernels.items()}
    print(f"  CUDA kernels per eager plan call (S={n_streams}), by mode: {json.dumps(shown)} "
          f"({retaken} profile(s) taken again for a dropped kernel event)")
    print(f"  CUDA kernels per eager learn call (S={n_streams}, every stream learns): "
          f"{sum(learn_kernels.values())} launches of {len(learn_kernels)} kernels")
    return {"wall_ms": wall_ms, "device_ms": busy, "plan_kernels": plan_kernels,
            "learn_launches": sum(learn_kernels.values())}


def _eager_fleet(state, xs, ys, cfg, mode, device):
    """The ticks as a plain loop of eager ``fleet_step`` calls (no runner,
    no graph): (state, outputs stacked over (T, S), seconds)."""
    import torch

    from repro_torch import engine

    _sync(device)
    t0 = time.perf_counter()
    outs = []
    for t in range(xs.shape[0]):
        state, out = engine.fleet_step(state, xs[t], ys[t], cfg, mode=mode)
        outs.append(out)
    _sync(device)
    secs = time.perf_counter() - t0
    return state, engine.types.tree_map(lambda *a: torch.stack(a), *outs), secs


def _chunk_shapes(n_ticks, chunks):
    """The chunk lengths ``run_fleet`` calls its runner at, over ``chunks``."""
    shapes = set()
    for chunk in chunks:
        c, t = min(chunk, n_ticks), 0
        while t < n_ticks:
            shapes.add(min(c, n_ticks - t))
            t += c
    return shapes


def _replay_busy(fn, device="cuda"):
    """``torch.profiler`` over one call of ``fn`` (graph replays): (wall
    ms, device busy ms, how many kernels it lists).  Device ms is None
    where the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 if dev else None
    return wall_ms, busy, len(dev)


def phase_chunk_runner(device="cuda", n_streams=FLEET_STREAMS):
    """6r: ``run_fleet``'s chunk runner (one CUDA graph replay per chunk).
    (a) ``har_odl.full()`` at S=16,384, phase 6's two runs (``train_phase``
    32 ticks, ``algo1`` 96 with the drift at 64) with ``chunk=16`` and with
    a ragged ``chunk=40``, each bit for bit an eager ``fleet_step`` loop on
    the same inputs (final state and every output); the projection, the
    RLS update and the plan's pass replayed at least once a tick; one
    capture per (mode, chunk shape); the result in the caller's P with the
    default donation, the caller's state untouched with ``donate=False``
    (which replays the donating run's graph);
    graphed and eager stream·ticks/s, capture ms and a profiled replay
    window's device busy share.  (b) one §3 paper trial (S=1, N=128, 1,008
    ``train_phase`` ticks, the auto ladder) through the runner, in the trial
    harness's chunks and as one graph of all its ticks, each bit for bit
    the eager loop, with its capture and replay ms."""
    import torch

    from repro_torch import engine
    from repro_torch.benchmarks import common
    from repro_torch.configs import har_odl
    from repro_torch.core import pruning
    from repro_torch.data import har
    from repro_torch.engine import fleet, graphs
    from repro_torch.engine.types import tree_leaves
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    card = _card()
    cfg = har_odl.full()
    data = har.generate(seed=SEED)
    res = {"fleet": {}, "replays": dict.fromkeys(ops.launch_counts, 0)}
    chunks = (16, 40)

    def count(before):
        for k, n in graphs.kernel_replays.items():
            res["replays"][k] += n - before[k]

    for mode, n_ticks, shift_at in _fleet_modes():
        xs, ys = _fleet_ticks(data, n_ticks, n_streams, shift_at, device, SEED + n_ticks)
        _eager_fleet(engine.init_fleet(cfg, n_streams, device), xs[:2], ys[:2], cfg, mode,
                     device)  # warm-up: the eager rate below is a steady one
        want, want_outs, eager_secs = _eager_fleet(engine.init_fleet(cfg, n_streams, device),
                                                   xs, ys, cfg, mode, device)
        fleet.release_chunk_graphs()
        graphs.reset_replay_counts()
        row = {"eager_stream_ticks_per_s": n_streams * n_ticks / eager_secs}
        for chunk in chunks:
            st0 = engine.init_fleet(cfg, n_streams, device)
            ptr = st0.elm.P.data_ptr()
            before = dict(graphs.kernel_replays)
            _sync(device)
            t0 = time.perf_counter()
            st, outs = engine.run_fleet(st0, xs, ys, cfg, mode=mode, chunk=chunk)
            _sync(device)
            row[f"chunk{chunk}_first_call_s"] = time.perf_counter() - t0
            count(before)
            differ = _bitwise_differs(want, st) + _bitwise_differs(want_outs, outs)
            check(not differ, f"6r {mode} chunk={chunk}: {differ} differ from the eager loop")
            check(st.elm.P.data_ptr() == ptr,
                  f"6r {mode} chunk={chunk}: the donated result is not in the caller's P")
            for name in PATH_KERNELS:
                got = graphs.kernel_replays[name] - before[name]
                check(got >= n_ticks, f"6r {mode} chunk={chunk}: {name} replayed {got} < "
                                      f"{n_ticks} times")
            del st0, st, outs
        shapes = _chunk_shapes(n_ticks, chunks)
        check(graphs.capture_counts.get("chunk_runner") == len(shapes),
              f"6r {mode}: {graphs.capture_counts.get('chunk_runner')} captures for chunk "
              f"shapes {sorted(shapes)}")
        row["captures"] = len(shapes)
        row["chunk_shapes"] = sorted(shapes)
        row["capture_ms"] = graphs.capture_ms.get("chunk_runner")
        # Replays only: the graphed rate, then one profiled replay window.
        before = dict(graphs.kernel_replays)
        st0 = engine.init_fleet(cfg, n_streams, device)
        _sync(device)
        t0 = time.perf_counter()
        engine.run_fleet(st0, xs, ys, cfg, mode=mode, chunk=16)
        _sync(device)
        row["graphed_stream_ticks_per_s"] = n_streams * n_ticks / (time.perf_counter() - t0)
        st0 = engine.init_fleet(cfg, n_streams, device)
        wall_ms, busy_ms, n_kernels = _replay_busy(
            lambda: engine.run_fleet(st0, xs, ys, cfg, mode=mode, chunk=16), device)
        count(before)
        row["profiled_wall_ms"] = wall_ms
        row["device_busy_ms"] = busy_ms
        row["busy_share"] = None if busy_ms is None else busy_ms / wall_ms
        row["profiled_kernels"] = n_kernels
        del st0
        if mode == "train_phase":
            # donate=False: the caller's state is left as it was, and the
            # graph is the donating run's (no capture).
            st0 = engine.init_fleet(cfg, n_streams, device)
            kept = [a.clone() for a in tree_leaves(st0)]
            before = dict(graphs.kernel_replays)
            st, outs = engine.run_fleet(st0, xs, ys, cfg, mode=mode, chunk=16, donate=False)
            count(before)
            check(graphs.capture_counts.get("chunk_runner") == len(shapes),
                  "6r donate=False: captured a graph of its own")
            check(all(torch.equal(a, b) for a, b in zip(tree_leaves(st0), kept)),
                  "6r donate=False: the caller's state changed")
            differ = _bitwise_differs(want, st) + _bitwise_differs(want_outs, outs)
            check(not differ, f"6r donate=False: {differ} differ from the eager loop")
            check(st.elm.P.data_ptr() != st0.elm.P.data_ptr(),
                  "6r donate=False: the result shares the caller's P")
            row["donate_false_bit_for_bit"] = True
            del st0, st, outs, kept
        res["fleet"][mode] = row
        del xs, ys, want, want_outs
        fleet.release_chunk_graphs()
        print(f"chunk runner (6r (a), S={n_streams}, {mode}, {n_ticks} ticks, chunk 16 and 40) "
              f"on {card}: bit for bit the eager loop; {json.dumps(row)}")

    # (b) one paper trial through the runner.
    splits = har.generate(seed=0)
    pcfg, core = common.boot_core(splits, 0, "auto", 128, "hash", device)
    ox, oy, _, _ = har.odl_split(splits, 0.6, 0)
    xs = torch.as_tensor(ox, device=device)[:, None]
    ys = torch.as_tensor(oy.astype("int32"), device=device)[:, None]
    start = engine.broadcast_streams(core, 1)
    start = start._replace(prune=pruning.reset_phase(start.prune))
    want, want_outs, eager_secs = _eager_fleet(engine.types.tree_map(torch.clone, start), xs, ys,
                                               pcfg, "train_phase", device)
    res["paper"] = {"ticks": len(ox), "eager_ms": 1e3 * eager_secs}
    # As the trial harness runs it (``engine.CHUNK_TICKS`` ticks a graph),
    # and as one graph of all 1,008 ticks (the reference's one scan).
    for tag, chunk in (("chunked", engine.CHUNK_TICKS), ("whole", None)):
        fleet.release_chunk_graphs()
        graphs.reset_replay_counts()
        before = dict(graphs.kernel_replays)
        secs = []
        for _ in range(2):  # the capture, then replays only
            st0 = engine.types.tree_map(torch.clone, start)
            _sync(device)
            t0 = time.perf_counter()
            st, outs = engine.run_fleet(st0, xs, ys, pcfg, mode="train_phase", chunk=chunk)
            _sync(device)
            secs.append(time.perf_counter() - t0)
            differ = _bitwise_differs(want, st) + _bitwise_differs(want_outs, outs)
            check(not differ, f"6r (b) paper trial ({tag}): {differ} differ from the eager loop")
        count(before)
        shapes = _chunk_shapes(len(ox), (chunk or len(ox),))
        check(graphs.capture_counts.get("chunk_runner") == len(shapes),
              f"6r (b) ({tag}): {graphs.capture_counts.get('chunk_runner')} captures for chunk "
              f"shapes {sorted(shapes)}")
        for name in PATH_KERNELS:
            check(graphs.kernel_replays[name] - before[name] == 2 * len(ox),
                  f"6r (b) ({tag}): {name} not replayed once a tick")
        res["paper"][tag] = {"chunk": chunk or len(ox), "first_call_ms": 1e3 * secs[0],
                             "capture_ms": graphs.capture_ms.get("chunk_runner"),
                             "replay_ms": 1e3 * secs[1],
                             "replays_a_call": graphs.replay_counts.get("chunk_runner", 0) // 2}
    res["paper"]["queries"] = int(st.prune.queries[0])
    fleet.release_chunk_graphs()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"chunk runner (6r (b), one paper trial: S=1, N=128, {len(ox)} ticks, auto ladder) on "
          f"{card}: bit for bit the eager loop; {json.dumps(res['paper'])}")
    print(f"  path kernels replayed in 6r: {json.dumps(res['replays'])}")
    print(f"  phase 6r took {res['seconds']:.1f} s ({card})")
    return res


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
        "oselm_rls_update": lambda a, out: (1, a[0].shape[0], a[2].shape[0], a[1].shape[1]),
        "plan_rows": lambda a, out: (*a[1].shape, a[2].shape[-1]),
        "readout": lambda a, out: tuple(a[1].shape),
        "row_abs_mean": lambda a, out: (math.prod(a[0].shape[:-1]), a[0].shape[-1]),
    }
    HELD = {"xorshift_projection": K1_SHAPES, "oselm_rls_update_fleet": K2_SHAPES,
            "oselm_rls_update": K3_SHAPES, "plan_rows": PLAN_SHAPES, "readout": READOUT_SHAPES,
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
    from repro_torch.engine import fleet, snapshot, stream
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
    fleet.release_chunk_graphs()  # the blocks' graphs and buffers
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
    head's kernels by name, the backbone's six costliest kernels, and the
    device busy share of the window (every kernel and copy, annotations
    excluded)."""
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
    backbone = {}
    for name, start, dur in work:
        where = next((r for r, ss in spans.items() if any(a <= start < b for a, b in ss)), None)
        if where is None:
            continue
        ms[where] += dur / 1e3
        if where == "serve.backbone":  # by the name's head: templates differ past it
            backbone[name[:80]] = backbone.get(name[:80], 0.0) + dur / 1e3 / n_ticks
        if where == "serve.head":
            part = ("projection" if "proj_kernel" in name else "plan_pass"
                    if "plan_rows_kernel" in name else "rls" if "rls_single_kernel" in name
                    else "rest_of_head")
            head[part] += dur / 1e3
    busy = sum(dur for _, _, dur in work) / 1e3
    top = sorted(backbone.items(), key=lambda kv: -kv[1])[:6]
    return {"backbone_ms": ms["serve.backbone"] / n_ticks, "head_ms": ms["serve.head"] / n_ticks,
            "head": {k: v / n_ticks for k, v in head.items()},
            "backbone_top": dict(top),
            "annotated": all(spans.values()), "busy_ms": busy / n_ticks,
            "wall_ms": wall_ms / n_ticks, "busy_share": busy / wall_ms if wall_ms else float("nan")}


def _decode_twice(params, cfg, prompts, max_len, n_tokens, device, what):
    """Two decodes of ``n_tokens`` from one prefill through ``launch.serve.
    _decode_feats`` (one CUDA graph a step), which must be bit for bit;
    returns the first's decode ms per token (host clock, synchronised)."""
    import torch

    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import model as model_lib

    _, state = model_lib.prefill(params, prompts, cfg, max_len=max_len)
    token_ms, first = [], []
    _sync(device)
    t0 = time.perf_counter()
    for f in serve_lib._decode_feats(params, state, prompts, cfg, n_tokens):
        _sync(device)
        token_ms.append(1e3 * (time.perf_counter() - t0))
        first.append(f)
        t0 = time.perf_counter()
    again = list(serve_lib._decode_feats(params, state, prompts, cfg, n_tokens))
    same = all(torch.equal(x, y) for x, y in zip(first, again))
    check(same and len(again) == n_tokens, f"{what}: the replayed decode differs")
    token_ms.sort()
    return {"p50": token_ms[len(token_ms) // 2], "p95": token_ms[int(0.95 * (len(token_ms) - 1))],
            "first": token_ms[0]}


def _serve_cascade(params, cfg, b, n_ticks, profile_ticks, device, card, labels, what):
    """6k (e) and (h), 6m (d): ``serve_step`` + ``serve_apply_labels`` for
    ``n_ticks`` at ``b`` streams, a synchronous teacher answering every
    queried stream with its domain; each tick must launch the projection and
    the plan's pass once and, with an answer, the RLS pass once.  Then a
    profiler window over ``profile_ticks`` more: the device ms of the
    backbone decode against the ODL head, and the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib

    res = {}
    n_dom = cfg.odl.n_out
    domains = torch.arange(b) % n_dom
    tables = TokenStream(TokenStreamConfig(cfg.vocab_size, 1, 1, n_domains=n_dom))._tables
    top_ids = torch.as_tensor(tables.argsort(axis=1)[:, -100:].copy())
    answers = domains.to(torch.int32).to(device)
    st = model_lib.init_serve_state(cfg, b, n_ticks + profile_ticks + 8, device)

    def cascade_tick(t, st, counts=None):
        tok = top_ids[domains, (t + torch.arange(b)) % 100][:, None].to(device)
        before = dict(ops.launch_counts)
        _, st, odl = model_lib.serve_step(params, st, tok, cfg)
        st = model_lib.serve_apply_labels(st, odl, answers, odl.queried, cfg)
        if counts is not None:
            q = int(odl.queried.sum())
            counts.append(q)
            d = {k: ops.launch_counts[k] - before.get(k, 0) for k in PATH_KERNELS}
            check(d["xorshift_projection"] == 1 and d["plan_rows"] == 1
                  and (d["oselm_rls_update_fleet"] == 1 if q
                       else d["oselm_rls_update_fleet"] <= 1),
                  f"{what} {labels[0]}: tick {t} launched {d} with {q} streams answered")
        return st

    queried = []
    t0 = time.perf_counter()
    for t in range(n_ticks):
        st = cascade_tick(t, st, queried)
    _sync(device)
    res["cascade"] = {"ticks": n_ticks, "queried": queried,
                      "tick_ms": 1e3 * (time.perf_counter() - t0) / n_ticks,
                      "meter_bytes": float(st.odl.meter.total.sum()),
                      "labels": int(st.odl.elm.count.sum())}
    check(res["cascade"]["labels"] == sum(queried), f"{what} {labels[0]}: labels applied != queried")
    print(f"  {labels[0]} cascade, {n_ticks} ticks at B={b}: queried per tick "
          f"{queried}; comm volume {res['cascade']['meter_bytes']:.0f} bytes metered "
          f"({sum(queried)} queries of {b * n_ticks} stream ticks); "
          f"{res['cascade']['tick_ms']:.2f} ms a tick (host clock) ({card})")

    for t in range(n_ticks, n_ticks + 2):
        st = cascade_tick(t, st)  # warm-up
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(n_ticks + 2, n_ticks + 2 + profile_ticks):
            st = cascade_tick(t, st)
        _sync(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    res["split"] = sp = _head_split(prof, profile_ticks, wall_ms)
    del st, prof
    if not sp["annotated"]:
        print(f"  {labels[1]} the split: not measured (the profiler gave no device-side spans of "
              "serve.backbone and serve.head)")
    print(f"  {labels[1]} a serve tick at B={b} ({profile_ticks} ticks profiled): device ms "
          f"backbone decode {sp['backbone_ms']:.3f}, ODL head {sp['head_ms']:.3f} (projection "
          f"{sp['head']['projection']:.4f}, plan's pass {sp['head']['plan_pass']:.4f}, RLS "
          f"{sp['head']['rls']:.4f}, the rest of the head {sp['head']['rest_of_head']:.4f}); "
          f"head share {100 * sp['head_ms'] / max(sp['backbone_ms'] + sp['head_ms'], 1e-9):.2f} "
          f"%; device busy {sp['busy_ms']:.3f} of {sp['wall_ms']:.3f} ms wall "
          f"({100 * sp['busy_share']:.1f} %) ({card})")
    print(f"      the backbone's six costliest kernels, device ms a tick: "
          + "; ".join(f"{name} {v:.3f}" for name, v in sp["backbone_top"].items()))
    return res


def _decode_tenant_migration(arch, variant, b, n_ticks, cut_at, max_len, device, card, what,
                             shapes):
    """6k (g), 6m (g): a ``decode`` tenant of ``arch`` at ``b`` streams on two
    port workers spawned on the card, migrated past tick ``cut_at``, which
    must end bit for bit as its solo run in this process (state, counters,
    label latencies); each worker's own scrape must show every path kernel,
    at shapes phases 2-4 held (added to ``shapes``)."""
    import torch

    from repro_torch import configs, engine
    from repro_torch.engine import snapshot, stream
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import model as model_lib
    from repro_torch.runtime import elastic
    from repro_torch.runtime import worker as worker_mod

    cfg = configs.get_config(arch, variant)
    spec = worker_mod.tenant_spec(
        "decoder", model_lib.core_config(cfg), s=b, mode="serve", capacity=8,
        backpressure="drop_oldest",
        ticks=serve_lib.decode_ticks_spec(arch, variant, b, SEED, n_ticks, tick_sleep_ms=20.0,
                                          max_len=max_len),
        teacher=worker_mod.latency_teacher_spec(n_out=cfg.odl.n_out, latency=2, jitter=1,
                                                seed=SEED))
    workers = []
    t_g = time.perf_counter()
    try:
        workers = [elastic.spawn_worker(f"b{i}", quantum=1) for i in range(2)]
        w0, w1 = workers
        w0.admit(spec)
        _wait_live_at(w0, ["decoder"], cut_at, {}, timeout_s=300)
        sent, wire = w0.extract("decoder")
        cut = snapshot.ticks_consumed(snapshot.decode_snapshot(wire))
        check(cut_at <= cut < n_ticks, f"{what}: cut at {cut}")
        check(w1.admit(sent, wire)["migrated"] is True, f"{what}: admit on b1 refused")
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
    check(not differ, f"{what}: state leaves {differ} differ from the solo run")
    bad = [f for f in COUNTERS if stats_wire[f] != getattr(solo_stats, f)]
    check(not bad and stats_wire["label_latency_ticks"] == list(solo_stats.label_latency_ticks),
          f"{what}: counters {bad} (or label latencies) differ from the solo run")
    check(stats_wire["stream_steps"] == b * n_ticks and stats_wire["reconciled"],
          f"{what}: {stats_wire}")
    res = {"worker": {"cut": cut, "wire_bytes": len(wire), "seconds": time.perf_counter() - t_g,
                      "peak_bytes": {n: sc["peak_bytes"] for n, sc in scrapes.items()}}}
    res["worker_launches"] = {k: sum(sc["launches"].get(k, 0) for sc in scrapes.values())
                              for k in scrapes["b0"]["launches"]}
    res["worker_replays"] = {k: sum(sc["replays"].get(k, 0) for sc in scrapes.values())
                             for k in scrapes["b0"]["replays"]}
    for name, sc in scrapes.items():
        for k in PATH_KERNELS:
            check(sc["launches"].get(k, 0) + sc["replays"].get(k, 0) > 0,
                  f"{what}: worker {name} ran {k} neither eagerly nor by a replay")
        miss = {k: sorted(v - set(_ShapeLog.HELD.get(k, ()))) for k, v in sc["shapes"].items()
                if v - set(_ShapeLog.HELD.get(k, ()))}
        check(not miss, f"{what}: worker {name} ran shapes phases 2-4 did not hold: {miss}")
        for k, v in sc["shapes"].items():
            shapes[k] = sorted(set(map(tuple, shapes.get(k, []))) | v)
    del solo_state, tree
    torch.cuda.empty_cache()
    print(f"  {what.split()[-1]} a decode tenant ({arch} {variant}, B={b}, {n_ticks} ticks) on "
          f"two port workers, migrated b0 -> b1 at tick {cut} ({len(wire)} wire bytes): bit for "
          f"bit its solo run in this process (state, counters, label latencies); path kernels by "
          f"each worker's own scrape (launches + replays): "
          + "; ".join(f"{n} " + str({k: sc['launches'].get(k, 0) + sc['replays'].get(k, 0)
                                     for k in PATH_KERNELS}) for n, sc in scrapes.items())
          + f"; worker peaks {res['worker']['peak_bytes']} bytes ({card})")
    return res


def phase_backbone(device="cuda"):
    """6k: the dense GQA backbone's serving path at qwen3-4b's full width
    (see the module docstring)."""
    import contextlib
    import io

    import torch

    from repro_torch import configs
    from repro_torch.engine import graphs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import layers, transformer
    from repro_torch.models import model as model_lib

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
        res["decode_ms_per_token"] = _decode_twice(params, cfg, prompts, max_len,
                                                   bb["replay_ticks"], device, "backbone (d)")
        print(f"  (d) two decodes of {bb['replay_ticks']} tokens from one prefill: bit for bit; "
              f"decode ms per token at B={b} (host clock, synchronised) p50 "
              f"{res['decode_ms_per_token']['p50']:.2f}, p95 "
              f"{res['decode_ms_per_token']['p95']:.2f} ({card})")

        # (e) the cascade, then (h) the split of a serve tick.
        res.update(_serve_cascade(params, cfg, b, bb["cascade_ticks"], bb["profile_ticks"],
                                  device, card, ("(e)", "(h)"), "backbone"))
        del params
        torch.cuda.empty_cache()

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
    res.update(_decode_tenant_migration(bb["arch"], bb["variant"], b, bb["worker_ticks"],
                                        bb["worker_cut"], max_len, device, card, "backbone (g)",
                                        res["shapes"]))
    res["seconds"] = time.perf_counter() - t_phase
    print(f"  kernel shapes on 6k's path (this process and the workers), each held in phases "
          f"2-4: {res['shapes']}")
    print(f"  kernels on 6k's path in this process (launches + replays): "
          + str({k: res['launches'].get(k, 0) + res['replays'].get(k, 0) for k in PATH_KERNELS}))
    print(f"  phase 6k took {res['seconds']:.1f} s ({card})")
    return res


class _MoeLog:
    """While active, collects on the device what each MoE layer call
    decides: its expert indices (``moe.route``) and the (token, choice)
    pairs it drops (``moe.dispatch_slots``' kept mask).  ``take_routes`` and
    ``take_dropped`` return and clear them.  With ``forced`` set (a function
    of the layer's index in the run and its token count), each layer routes
    its tokens to the experts it returns instead, their gates taken from the
    layer's own probabilities and renormalized as ``moe.route`` does."""

    def __init__(self):
        self.forced = None

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self._saved = moe.route, moe.dispatch_slots
        self.routes, self.dropped = [], []

        def route(xt, router, cfg):
            probs, gate, idx, aux = self._saved[0](xt, router, cfg)
            if self.forced is not None:
                idx = self.forced(len(self.routes), xt.shape[0])
                gate = probs.gather(1, idx)
                gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
            self.routes.append(idx)
            return probs, gate, idx, aux

        def dispatch_slots(*a):
            out = self._saved[1](*a)
            self.dropped.append((~out[2]).sum())
            return out

        moe.route, moe.dispatch_slots = route, dispatch_slots
        return self

    def take_routes(self) -> list:
        routes, self.routes = self.routes, []
        return routes

    def take_dropped(self) -> int:
        import torch

        n = int(torch.stack(self.dropped).sum()) if self.dropped else 0
        self.dropped = []
        return n

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route, moe.dispatch_slots = self._saved


def _moe_build(cfg, want_params, device, card, what):
    """(a): the model built on the card from the seed, counted, with the
    build seconds and the allocator's peak."""
    import torch

    from repro_torch.models import layers
    from repro_torch.models import model as model_lib

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_lib.build_params(cfg, SEED, device)
    _sync(device)
    res = {"build_s": time.perf_counter() - t0,
           "build_peak_bytes": torch.cuda.max_memory_allocated(),
           "params": sum(t.numel() for t in _model_leaves(params))}
    schema_count = layers.count_params(model_lib.build_schema(cfg))
    check(res["params"] == schema_count == want_params,
          f"{what}: {res['params']} params built, schema {schema_count}")
    attn = (f"MLA q/kv lora {cfg.q_lora_rank}/{cfg.kv_lora_rank}" if cfg.use_mla
            else f"{cfg.n_heads}/{cfg.n_kv_heads} heads")
    print(f"  (a) {cfg.arch_id} ({cfg.n_layers} layers, d_model {cfg.d_model}, {attn}, "
          f"{cfg.n_experts} routed experts top-{cfg.top_k} of d_ff {cfg.d_ff_expert} + "
          f"{cfg.n_shared_experts} shared, vocab {cfg.vocab_size}) on {card}: {res['params']} "
          f"parameters (count_params {schema_count}), built in {res['build_s']:.2f} s, "
          f"allocator peak {res['build_peak_bytes']} bytes")
    return params, res


def _decode_against_forward(params, cfg, toks, max_len, log):
    """One depth of 6m (b): the 16-token forward's logits of the last token,
    then the prefill of the others and ``serve_step`` of the last, unforced
    and with the forward's routing forced on them (``log``, a ``_MoeLog``).
    Returns the forced run's Frobenius relative error, max abs difference
    and excess over atol 0.15, rtol 0.05 (<= 0 within), and the unforced
    run's, with its streams within the bound and those whose last token
    routes alike at every layer."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.models import model as model_lib

    b, s = toks.shape
    n = cfg.n_layers
    h_all, _ = transformer.lm_hidden(params, toks, cfg)
    full = transformer.lm_logits(params, h_all[:, -1:], cfg)[:, 0]
    del h_all
    full_routes = [r.view(b, s, -1) for r in log.take_routes()]

    def decode(forced):
        log.forced = forced
        _, st = model_lib.prefill(params, toks[:, :-1], cfg, max_len=max_len)
        logits, st, _ = model_lib.serve_step(params, st, toks[:, -1:], cfg)
        log.forced = None
        return logits, log.take_routes()[-n:]

    free, dec_routes = decode(None)
    # The prefill's layers, then the decode step's: layer i % n.
    forced, _ = decode(lambda i, t: (full_routes[i % n][:, -1] if t == b else
                                     full_routes[i % n][:, :-1].reshape(t, -1)))
    check(len(dec_routes) == len(full_routes) == n, f"{len(dec_routes)}/{len(full_routes)} "
                                                    f"routed layers")
    alike = torch.ones(b, dtype=torch.bool, device=toks.device)
    for r_dec, r_full in zip(dec_routes, full_routes):
        alike &= (r_dec.sort(-1).values == r_full[:, -1].sort(-1).values).all(-1)

    def excess(logits):  # (B,): <= 0 where within atol 0.15, rtol 0.05
        g, w = logits.float(), full.float()
        return ((g - w).abs() - (0.15 + 0.05 * w.abs())).amax(-1)

    over_free = excess(free)
    return dict(zip(("fro_rel", "max_abs"), _fro_and_max(forced, full)),
                excess_over_bound=float(excess(forced).max()),
                unforced=dict(zip(("fro_rel", "max_abs"), _fro_and_max(free, full)),
                              last_token_routes_alike=int(alike.sum()),
                              streams_within=int((over_free <= 0).sum())))


def _moe_decode_vs_prefill(params, cfg, toks, max_len, what):
    """(b): at capacity factor E/k (no pair can drop), ``serve_step`` of the
    last token after a prefill of the others against ``lm_hidden``'s logits
    over all.  Routing is a thresholded output: where a token's router nearly
    ties, the prefill, the decode and the 16-token forward (other matrix
    shapes, other cuBLAS kernels, other roundings) may pick different
    experts at some layer, and then that stream's logits, and those of every
    later token attending to it, differ by O(1).  So the prefill and the
    decode are held with ``lm_hidden``'s routing forced on them (each token
    to the experts the forward chose for it, gates from its own
    probabilities): the check sees the caches and the arithmetic, not the
    router's thresholds.  Within atol 0.15, rtol 0.05 at ``bound_depth``
    layers (the reference's bounds come from its 2-layer smoke model); at
    full depth the rounding differences compound through the experts'
    large outputs (the reference's init scales a 3-D expert leaf by its
    leading dim, E), so that depth is printed, with the unforced run's
    counts.  Then, at the config's own factor, the pairs the prefill and one
    decode step drop."""
    import torch

    from repro_torch.models import model as model_lib

    b, s = toks.shape
    exact = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    depths = (MOE["bound_depth"], cfg.n_layers)
    res = {"decode_vs_prefill": {}}
    with _MoeLog() as log:
        for depth in depths:
            p_cut = dict(params, layers=_first_layers(params["layers"], depth))
            res["decode_vs_prefill"][depth] = _decode_against_forward(
                p_cut, exact.replace(n_layers=depth), toks, max_len, log)
        log.take_dropped()
        _, st = model_lib.prefill(params, toks[:, :-1], cfg, max_len=max_len)
        pre = log.take_dropped()
        model_lib.serve_step(params, st, toks[:, -1:], cfg)
        dec = log.take_dropped()
        log.take_routes()
        del st
    torch.cuda.empty_cache()
    bounded = res["decode_vs_prefill"][depths[0]]
    check(bounded["excess_over_bound"] <= 0,
          f"{what} (b): at {depths[0]} layers, routed as lm_hidden routes, decode beyond "
          f"prefill's logits by {bounded['excess_over_bound']} past the bound")
    pairs = cfg.n_layers * cfg.top_k
    res["dropped"] = {"capacity_factor": cfg.capacity_factor, "prefill": pre,
                      "prefill_pairs": pairs * b * (s - 1), "decode": dec, "decode_pairs": pairs * b}
    deep = res["decode_vs_prefill"][depths[1]]
    print(f"  (b) decode against prefill at B={b}, capacity factor {exact.capacity_factor:.4g}, "
          f"routed as lm_hidden routes: at {depths[0]} layers within atol 0.15, rtol 0.05 "
          f"(Frobenius rel {bounded['fro_rel']:.4f}, max abs {bounded['max_abs']:.4f}); "
          f"through all {depths[1]} (printed) Frobenius rel {deep['fro_rel']:.4f}, max abs "
          f"{deep['max_abs']:.4f}, excess over the bound {deep['excess_over_bound']:.4f}")
    for depth in depths:
        u = res["decode_vs_prefill"][depth]["unforced"]
        print(f"      unforced at {depth} layers: {u['last_token_routes_alike']} of {b} streams' "
              f"last token routes alike at every layer, {u['streams_within']} of {b} streams "
              f"within the bound (Frobenius rel {u['fro_rel']:.4f}, max abs {u['max_abs']:.4f})")
    print(f"      at the default capacity factor {cfg.capacity_factor}: the prefill dropped {pre} "
          f"of {res['dropped']['prefill_pairs']} (token, choice) pairs, a decode step {dec} of "
          f"{res['dropped']['decode_pairs']}")
    return res


def phase_moe(device="cuda"):
    """6m: the MoE archs' serving path, deepseek-moe-16b at full width and
    deepseek-v2-236b at full width and 4 layers (see the module docstring)."""
    import contextlib
    import io

    import torch

    from repro_torch import configs
    from repro_torch.engine import graphs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_lib

    t_phase = time.perf_counter()
    card = _card()
    torch.cuda.empty_cache()
    mm = MOE
    cfg = configs.get_config(mm["arch"], mm["variant"])
    b, max_len = mm["batch"], mm["max_len"]
    gen = torch.Generator().manual_seed(SEED)
    res = {}
    print(f"moe (6m, {mm['arch']} {mm['variant']} and {mm['mla_arch']} at full width, "
          f"{mm['mla_layers']} of its layers) on {card}: "
          f"{torch.cuda.memory_allocated()} bytes allocated before it")
    graphs.reset_replay_counts()
    ops.reset_launch_counts()
    with _ShapeLog() as log:
        params, res["build"] = _moe_build(cfg, mm["params"], device, card, "moe")
        toks = torch.randint(0, cfg.vocab_size, (b, mm["prompt_len"]), generator=gen).to(device)
        res.update(_moe_decode_vs_prefill(params, cfg, toks, max_len, "moe"))
        res["decode_ms_per_token"] = _decode_twice(params, cfg, toks, max_len, mm["replay_ticks"],
                                                   device, "moe (c)")
        dm = res["decode_ms_per_token"]
        print(f"  (c) two decodes of {mm['replay_ticks']} tokens from one prefill: bit for bit; "
              f"decode ms per token at B={b} (host clock, synchronised) p50 {dm['p50']:.2f}, "
              f"p95 {dm['p95']:.2f} ({card})")
        res.update(_serve_cascade(params, cfg, b, mm["cascade_ticks"], mm["profile_ticks"],
                                  device, card, ("(d)", "(d)"), "moe"))
        del params
        torch.cuda.empty_cache()

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            queries, skips = serve_lib.serve(
                arch=mm["arch"], variant=mm["variant"], batch=b, gen_tokens=mm["serve_tokens"],
                tenants=2, teacher_latency=2, seed=SEED, device=device)
        out = buf.getvalue()
        print("\n".join("    " + line for line in out.splitlines()))
        rep = _serve_report(out)
        rep.update(queries=queries, skips=skips)
        check(rep["reconciled"] == 2 and rep["broken"] == 0
              and queries + skips == 2 * b * mm["serve_tokens"],
              f"moe (e): serve did not reconcile: {rep}")
        res["serve"] = rep
        torch.cuda.empty_cache()
        print(f"  (e) serve({mm['arch']} {mm['variant']}, B={b}, {mm['serve_tokens']} tokens, 2 "
              f"tenants, latency 2): reconciled; {rep['steps_per_s']:.0f} stream·ticks/s "
              f"aggregate; tenant tick p50/p95 ms {rep['tick_ms']} ({card})")

        # (f) deepseek-v2-236b at full width, cut in depth: (a)-(c) with the
        # MLA latent cache, onehot and dus.
        mla = configs.get_config(mm["mla_arch"], "full").replace(n_layers=mm["mla_layers"])
        print(f"  (f) {mm['mla_arch']} at full width, {mm['mla_layers']} of its 60 layers "
              f"(reduced: depth 60 -> {mm['mla_layers']}, one card):")
        params, res["mla_build"] = _moe_build(mla, mm["mla_params"], device, card, "moe (f)")
        toks = torch.randint(0, mla.vocab_size, (b, mm["prompt_len"]), generator=gen).to(device)
        res["mla"] = _moe_decode_vs_prefill(params, mla, toks, max_len, "moe (f)")
        res["mla"]["decode_ms_per_token"] = {}
        for mode in ("onehot", "dus"):
            dm = _decode_twice(params, mla.replace(cache_update=mode), toks, max_len,
                               mm["replay_ticks"], device, f"moe (f) {mode}")
            res["mla"]["decode_ms_per_token"][mode] = dm
            print(f"  (c) {mode}: two decodes of {mm['replay_ticks']} tokens from one prefill: "
                  f"bit for bit; decode ms per token at B={b} (host clock, synchronised) p50 "
                  f"{dm['p50']:.2f}, p95 {dm['p95']:.2f} ({card})")
        del params, toks
        torch.cuda.empty_cache()
    res["launches"] = dict(ops.launch_counts)
    res["replays"] = dict(graphs.kernel_replays)
    for k in PATH_KERNELS:
        check(res["launches"].get(k, 0) + res["replays"].get(k, 0) > 0,
              f"moe: {k} ran neither eagerly nor by a replay on 6m's path")
    missing = log.missing()
    check(not missing, f"moe: shapes phases 2-4 did not hold: {missing}")
    res["shapes"] = {k: sorted(v) for k, v in log.shapes.items() if v}

    # (g) an MLA decode tenant on two port workers, migrated after tick 16.
    res.update(_decode_tenant_migration(mm["mla_arch"], mm["worker_variant"], b,
                                        mm["worker_ticks"], mm["worker_cut"], max_len, device,
                                        card, "moe (g)", res["shapes"]))
    res["seconds"] = time.perf_counter() - t_phase
    print(f"  kernel shapes on 6m's path (this process and the workers), each held in phases "
          f"2-4: {res['shapes']}")
    print(f"  kernels on 6m's path in this process (launches + replays): "
          + str({k: res['launches'].get(k, 0) + res['replays'].get(k, 0) for k in PATH_KERNELS}))
    print(f"  phase 6m took {res['seconds']:.1f} s ({card})")
    return res


# ---------------------------------------------------------------------------
# Phase 6n: the SSD and hybrid RG-LRU archs' serving path (models/ssm.py,
# models/rglru.py)
# ---------------------------------------------------------------------------


def _unit_scale(params, cfg):
    """What divides logits to the unit scale the reference's decode-against-
    prefill bound is set for (its dense check's lm_head drawn at
    1/sqrt(d)): sqrt(d) times the output matrix's rms, ~1 for such a head
    and ~sqrt(d) = 39 for mamba2's tied embedding drawn at std 1."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return float(w.float().pow(2).mean().sqrt()) * cfg.d_model ** 0.5


def _cut_depth(params, cfg, depth):
    """The first ``depth`` layers (views) and their config: a hybrid stack's
    first depth / len(pattern) groups, its tail only at full depth."""
    if depth == cfg.n_layers:
        return params, cfg
    if cfg.hybrid_pattern:
        top = {k: v for k, v in params.items() if k not in ("groups", "tail")}
        return (dict(top, groups=_first_layers(params["groups"],
                                              depth // len(cfg.hybrid_pattern))),
                cfg.replace(n_layers=depth))
    return dict(params, layers=_first_layers(params["layers"], depth)), cfg.replace(n_layers=depth)


def _recurrent_vs_forward(params, cfg, toks, n_prompt, n_decode, max_len, serve):
    """One depth of 6n (b) or (c): ``lm_hidden`` over all of ``toks``, then
    the prefill of the first ``n_prompt`` and ``n_decode`` decode steps fed
    the next tokens (``serve_step`` when ``serve``, else ``lm_decode_hidden``),
    against the forward at those positions: the logits at unit scale and,
    without ``serve``, the hidden states, within atol 0.15, rtol 0.05."""
    import torch

    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer

    scale = _unit_scale(params, cfg)
    h_all, _ = transformer.lm_hidden(params, toks, cfg)
    want_h = h_all[:, n_prompt:n_prompt + n_decode]
    want = transformer.lm_logits(params, want_h, cfg)
    del h_all
    _, st = model_lib.prefill(params, toks[:, :n_prompt], cfg, max_len=max_len)
    got_h, got = [], []
    for i in range(n_decode):
        tok = toks[:, n_prompt + i:n_prompt + i + 1]
        if serve:
            logits, st, _ = model_lib.serve_step(params, st, tok, cfg)
            got.append(logits)
        else:
            h, caches = transformer.lm_decode_hidden(params, tok, st.caches, st.pos, cfg)
            st = st._replace(caches=caches, pos=st.pos + 1)
            got_h.append(h[:, 0])
            got.append(transformer.lm_logits(params, h, cfg)[:, 0])
    del st
    got = torch.stack(got, 1)
    fro, worst = _fro_and_max(got, want)
    out = {"logits_fro_rel": fro, "logits_max_abs": worst,
           "unit_excess": _within(got.float() / scale, want.float() / scale, 0.15, 0.05),
           "unit_scale": scale}
    if not serve:
        out["hidden_excess"] = _within(torch.stack(got_h, 1), want_h, 0.15, 0.05)
        out["hidden_fro_rel"], out["hidden_max_abs"] = _fro_and_max(torch.stack(got_h, 1),
                                                                   want_h)
    return out


def _recurrent_arch(arch, device, card, gen, serve_driver):
    """6n (a)-(f) for one arch (see the module docstring); returns its
    results, the launches and replays counted from 0 around it."""
    import contextlib
    import io

    import torch

    from repro_torch import configs
    from repro_torch.engine import graphs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import layers, transformer
    from repro_torch.models import model as model_lib

    rc = RECURRENT[arch]
    cfg = configs.get_config(arch, "full")
    b, max_len, what = RECURRENT["batch"], RECURRENT["max_len"], f"recurrent ({arch})"
    res = {}
    graphs.reset_replay_counts()
    ops.reset_launch_counts()
    # (a) build on the card from the seed; count it.
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_lib.build_params(cfg, SEED, device)
    _sync(device)
    res["build_s"] = time.perf_counter() - t0
    res["build_peak_bytes"] = torch.cuda.max_memory_allocated()
    res["params"] = sum(t.numel() for t in _model_leaves(params))
    schema_count = layers.count_params(model_lib.build_schema(cfg))
    check(res["params"] == schema_count == rc["params"],
          f"{what}: {res['params']} params built, schema {schema_count}")
    mixer = (f"SSD d_inner {cfg.d_inner}, {cfg.ssm_nheads} heads of {cfg.ssm_headdim}, state "
             f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}" if cfg.family == "ssm" else
             f"pattern {'/'.join(cfg.hybrid_pattern)}, lru_width {cfg.lru_width}, "
             f"{cfg.n_heads}/{cfg.n_kv_heads} heads, window {cfg.sliding_window}, "
             f"d_ff {cfg.d_ff}")
    print(f"  (a) {arch} ({cfg.n_layers} layers, d_model {cfg.d_model}, {mixer}, vocab "
          f"{cfg.vocab_size}) on {card}: {res['params']} parameters (count_params "
          f"{schema_count}), built in {res['build_s']:.2f} s, allocator peak "
          f"{res['build_peak_bytes']} bytes")

    # (b) decode against prefill at B streams; (c) the long prompt at B=2.
    depths = (rc["bound_depth"], cfg.n_layers)
    toks = torch.randint(0, cfg.vocab_size, (b, RECURRENT["prompt_len"]), generator=gen).to(device)
    long = torch.randint(0, cfg.vocab_size, (2, rc["long_forward"]), generator=gen).to(device)
    for part, args in (("b", (toks, toks.shape[1] - 1, 1, max_len, True)),
                       ("c", (long, rc["long_prompt"], rc["long_decode"], rc["long_max_len"],
                              False))):
        res[part] = {}
        for depth in depths:
            p_cut, c_cut = _cut_depth(params, cfg, depth)
            res[part][depth] = _recurrent_vs_forward(p_cut, c_cut, *args)
            torch.cuda.empty_cache()
        bounded, deep = res[part][depths[0]], res[part][depths[1]]
        over = max(bounded["unit_excess"], bounded.get("hidden_excess", -1.0))
        check(over <= 0, f"{what} ({part}): at {depths[0]} layers decode beyond the forward by "
                         f"{over} past atol 0.15, rtol 0.05: {bounded}")
        where = (f"B={b}: prefill {toks.shape[1] - 1} tokens, serve_step token {toks.shape[1]}"
                 if part == "b" else
                 f"B=2: prefill {rc['long_prompt']} tokens (max_len {rc['long_max_len']}), "
                 f"decode {rc['long_decode']} against lm_hidden over {rc['long_forward']}")
        hid = ("" if part == "b" else f"hidden excess {bounded['hidden_excess']:.4f}, ")
        hid_deep = ("" if part == "b" else f"hidden excess {deep['hidden_excess']:.4f}, ")
        print(f"  ({part}) decode against the forward, {where}: at {depths[0]} layers within "
              f"atol 0.15, rtol 0.05 ({hid}unit-scale logits excess "
              f"{bounded['unit_excess']:.4f}; logits Frobenius rel "
              f"{bounded['logits_fro_rel']:.4f}, max abs {bounded['logits_max_abs']:.4f}, "
              f"unit scale {bounded['unit_scale']:.2f}); through all {depths[1]} (printed) "
              f"{hid_deep}unit-scale logits excess {deep['unit_excess']:.4f}, logits Frobenius "
              f"rel {deep['logits_fro_rel']:.4f}, max abs {deep['logits_max_abs']:.4f}")
    del toks, long

    # (d) replay determinism, decode ms per token and the cache bytes.
    prompts = torch.randint(0, cfg.vocab_size, (b, RECURRENT["prompt_len"]),
                            generator=gen).to(device)
    res["decode_ms_per_token"] = dm = _decode_twice(params, cfg, prompts, max_len,
                                                    RECURRENT["replay_ticks"], device,
                                                    f"{what} (d)")
    res["cache_bytes"] = sum(t.numel() * t.element_size() for t in _model_leaves(
        transformer.init_caches(cfg, b, max_len, device="meta")))
    del prompts
    torch.cuda.empty_cache()
    print(f"  (d) two decodes of {RECURRENT['replay_ticks']} tokens from one prefill: bit for "
          f"bit; decode ms per token at B={b} (host clock, synchronised) p50 {dm['p50']:.2f}, "
          f"p95 {dm['p95']:.2f}; the caches {res['cache_bytes']} bytes ({card})")

    # (e) the cascade and the split of a serve tick.
    res.update(_serve_cascade(params, cfg, b, RECURRENT["cascade_ticks"],
                              RECURRENT["profile_ticks"], device, card, ("(e)", "(e)"), what))
    del params
    torch.cuda.empty_cache()

    # (f) the serve driver.
    if serve_driver:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            queries, skips = serve_lib.serve(
                arch=arch, variant="full", batch=b, gen_tokens=RECURRENT["serve_tokens"],
                tenants=2, teacher_latency=2, seed=SEED, device=device)
        out = buf.getvalue()
        print("\n".join("    " + line for line in out.splitlines()))
        rep = _serve_report(out)
        rep.update(queries=queries, skips=skips)
        check(rep["reconciled"] == 2 and rep["broken"] == 0
              and queries + skips == 2 * b * RECURRENT["serve_tokens"],
              f"{what} (f): serve did not reconcile: {rep}")
        res["serve"] = rep
        torch.cuda.empty_cache()
        print(f"  (f) serve({arch} full, B={b}, {RECURRENT['serve_tokens']} tokens, 2 tenants, "
              f"latency 2): reconciled; {rep['steps_per_s']:.0f} stream·ticks/s aggregate; "
              f"tenant tick p50/p95 ms {rep['tick_ms']} ({card})")
    res["launches"] = dict(ops.launch_counts)
    res["replays"] = dict(graphs.kernel_replays)
    for k in PATH_KERNELS:
        check(res["launches"].get(k, 0) + res["replays"].get(k, 0) > 0,
              f"{what}: {k} ran neither eagerly nor by a replay on its path")
    return res


def phase_recurrent(device="cuda"):
    """6n: the SSD and hybrid RG-LRU archs' serving path, mamba2-780m and
    recurrentgemma-9b at full width and depth (see the module docstring)."""
    import torch

    t_phase = time.perf_counter()
    card = _card()
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(SEED)
    print(f"recurrent (6n, mamba2-780m and recurrentgemma-9b full) on {card}: "
          f"{torch.cuda.memory_allocated()} bytes allocated before it")
    res = {}
    with _ShapeLog() as log:
        res["ssm"] = _recurrent_arch("mamba2-780m", device, card, gen, serve_driver=True)
        print("  (g) recurrentgemma-9b full: (a)-(e)")
        res["hybrid"] = _recurrent_arch("recurrentgemma-9b", device, card, gen,
                                        serve_driver=False)
    missing = log.missing()
    check(not missing, f"recurrent: shapes phases 2-4 did not hold: {missing}")
    res["shapes"] = {k: sorted(v) for k, v in log.shapes.items() if v}

    # (h) a hybrid decode tenant on two port workers, migrated after tick 16.
    res["worker"] = _decode_tenant_migration(
        "recurrentgemma-9b", "smoke", RECURRENT["batch"], RECURRENT["worker_ticks"],
        RECURRENT["worker_cut"], RECURRENT["max_len"], device, card, "recurrent (h)",
        res["shapes"])
    res["seconds"] = time.perf_counter() - t_phase
    print(f"  kernel shapes on 6n's path (this process and the workers), each held in phases "
          f"2-4: {res['shapes']}")
    for key, arch in (("ssm", "mamba2-780m"), ("hybrid", "recurrentgemma-9b")):
        r = res[key]
        print(f"  kernels on 6n's {arch} path in this process (launches + replays): "
              + str({k: r['launches'].get(k, 0) + r['replays'].get(k, 0) for k in PATH_KERNELS}))
    print(f"  phase 6n took {res['seconds']:.1f} s ({card})")
    return res


def _param_slice_sums(params, cfg):
    """One f64 sum per param slice (each layer or pattern group of a stacked
    leaf, each other leaf whole), in a fixed order, on the host: a slice
    whose sum changed has moved."""
    import torch

    from repro_torch.models import model as model_lib

    names = model_lib.stacked_names(cfg)
    sums = [t.double().sum() for k, v in params.items() if k not in names
            for t in _model_leaves({k: v})]
    for name in names:
        for t in _model_leaves(params[name]):
            sums.extend(s.double().sum() for s in t.unbind(0))
    return torch.stack(sums).cpu()


def _clustered_feats(rng, n, centers, ambiguous=False):
    """``n`` rows around the class ``centers`` (m, d) and their labels;
    ``ambiguous`` moves every other row halfway to the next class's centre,
    so that a warm head is sure of some rows (they prune) and not of the
    others (they train)."""
    import numpy as np

    m = centers.shape[0]
    labels = rng.integers(0, m, n).astype(np.int32)
    feats = centers[labels] + 0.5 * rng.standard_normal((n, centers.shape[1]))
    if ambiguous:
        a = labels[1::2]
        feats[1::2] = 0.5 * (centers[a] + centers[(a + 1) % m]) \
            + 0.5 * rng.standard_normal((len(a), centers.shape[1]))
    return feats.astype(np.float32), labels


def _train_steps(arch, variant, device, card, tag, cfg=None, note="", tcfg=None, batch=None,
                 seq=None, after=None):
    """6l (b) for one config (``cfg``, or ``arch``/``variant``'s):
    ``launch.train.train`` for TRAIN's steps at ``batch`` x ``seq`` (TRAIN's
    by default) under ``tcfg`` (the default ``TrainConfig``), the
    projection and one-head RLS launches (and graph replays) counted from 0
    around it; every loss finite, every param slice moved (against the
    seed's params drawn beforehand, in the master params' dtype), the head's
    count equal to the queried rows, each path kernel launched once (RLS)
    or twice (projection) a step; for an MoE stack every step's aux loss
    finite and 0.01 aux printed.  ``after(state, cfg, tcfg)``, if given,
    runs on the trained state before it is freed.  Returns the results."""
    import torch

    from repro_torch import configs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.engine import graphs
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_lib
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib

    tr = TRAIN
    cfg = cfg or configs.get_config(arch, variant)
    tcfg = tcfg or TrainConfig()
    b, seq, n_steps = batch or tr["batch"], seq or tr["seq"], tr["steps"]
    schema = model_lib.build_schema(cfg)
    init = layers.init_params(schema, SEED, device, dtype=getattr(torch, tcfg.param_dtype))
    n_params = sum(t.numel() for t in _model_leaves(init))
    before = _param_slice_sums(init, cfg)
    del init
    torch.cuda.empty_cache()
    steps = []
    last = [time.perf_counter()]

    def on_step(step, metrics):
        _sync(device)
        now = time.perf_counter()
        steps.append({"step": step, "loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"]),
                      "odl_query_frac": float(metrics["odl_query_frac"]),
                      "odl_theta": float(metrics["odl_theta"]), "s": now - last[0]})
        if cfg.n_experts:
            steps[-1]["aux"] = float(auxes.values[-1])
        last[0] = now

    torch.cuda.reset_peak_memory_stats()
    graphs.reset_replay_counts()
    ops.reset_launch_counts()
    last[0] = time.perf_counter()
    with _AuxLog() as auxes:
        state, losses = train_lib.train(arch, variant, steps=n_steps, batch=b, seq=seq,
                                        seed=SEED, log_every=n_steps, device=device, cfg=cfg,
                                        on_step=on_step, tcfg=tcfg)
    _sync(device)
    res = {"peak_bytes": torch.cuda.max_memory_allocated(), "launches": dict(ops.launch_counts),
           "replays": dict(graphs.kernel_replays), "params": n_params}
    check(len(losses) == n_steps and all(math.isfinite(x) for x in losses),
          f"{tag}: losses {losses}")
    moved = _param_slice_sums(state.params, cfg) != before
    check(bool(moved.all()), f"{tag}: {int((~moved).sum())} of {moved.numel()} param slices "
                             f"did not move")
    queried = sum(round(r["odl_query_frac"] * b) for r in steps)
    count = int(state.odl.elm.count)
    check(count == queried and count == int(state.odl.prune.queries),
          f"{tag}: odl count {count}, queried rows {queried}")
    if cfg.n_experts:
        check(len(auxes.values) == n_steps and all(math.isfinite(r["aux"]) for r in steps),
              f"{tag}: aux losses {[r.get('aux') for r in steps]}")
    if after is not None:
        res.update(after(state, cfg, tcfg))
    del state
    torch.cuda.empty_cache()
    per_step = [r["s"] for r in steps]
    steady = sorted(per_step[1:])[len(per_step[1:]) // 2]
    tokens = b * seq
    flops = 6.0 * n_params * tokens  # model FLOPs; remat's recompute not counted
    res.update(losses=losses, steps=steps, s_per_step=per_step, steady_s=steady,
               tokens_per_s=tokens / steady, model_flops=flops,
               bf16_peak_share=flops / steady / PEAK_BF16_FLOPS, odl_count=count,
               slices=moved.numel())
    want = {"xorshift_projection": 2 * n_steps, "oselm_rls_update": n_steps}
    got = {k: res["launches"].get(k, 0) + res["replays"].get(k, 0) for k in TRAIN_KERNELS}
    check(got == want and not any(res["replays"].get(k, 0) for k in TRAIN_KERNELS),
          f"{tag}: path kernels {got} (launches {res['launches']}, replays {res['replays']}), "
          f"want {want} launched")
    print(f"  {tag} launch.train.train({cfg.arch_id} {variant}{note}, {n_steps} steps, B={b}, "
          f"S={seq}): {n_params} parameters; losses {[round(x, 4) for x in losses]}, all "
          f"finite; all {moved.numel()} param slices moved; odl count {count} == {queried} "
          f"queried rows; per step odl_query_frac {[r['odl_query_frac'] for r in steps]}, "
          f"odl_theta {[r['odl_theta'] for r in steps]}, s/step "
          f"{[round(x, 3) for x in per_step]} (step 1 includes the build); steady "
          f"{steady:.3f} s (median of steps 2-{n_steps}, host clock, synchronised), "
          f"{tokens / steady:.0f} tokens/s; allocator peak {res['peak_bytes']} bytes; model "
          f"FLOPs a step 6 x N x tokens = {flops:.3e} ({100 * res['bf16_peak_share']:.1f} % of "
          f"the bf16 dense peak, information); path kernels launched {got} ({card})")
    if cfg.n_experts:
        res["aux"] = [r["aux"] for r in steps]
        print(f"  {tag} 0.01 aux per step (the MoE layers' load-balancing loss in the loss): "
              f"{[round(0.01 * r['aux'], 6) for r in steps]}, all finite")
    return res


class _AuxLog:
    """While active, keeps the aux loss of every ``transformer.lm_hidden``
    call (the MoE layers' sum; one a training step at ``microbatches`` 1),
    detached, in ``values``."""

    def __enter__(self):
        from repro_torch.models import transformer

        self.values = []
        self._saved = transformer.lm_hidden

        def logged(*a, **kw):
            hidden, aux = self._saved(*a, **kw)
            self.values.append(aux.detach() if hasattr(aux, "detach") else aux)
            return hidden, aux

        transformer.lm_hidden = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer

        transformer.lm_hidden = self._saved


def _train_batch(cfg, step, b, seq, device):
    """``launch.train.train``'s batch of ``step`` at ``b`` x ``seq`` (the
    frames too, for the encoder-decoder), on ``device``."""
    import torch

    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.launch import train as train_lib

    stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                           global_batch=b, n_domains=cfg.odl.n_out, seed=SEED))
    batch = stream.batch(step)
    if cfg.enc_dec:
        batch["frames"] = train_lib.frames(step, b, seq, cfg.d_model)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _train_replay_resume(arch, device, tag):
    """6l (c) at ``arch``'s smoke width on the card: two ``train_step``s from
    one state bit for bit, and TRAIN's resume_at steps + resume to twice as
    many bit for bit as many uninterrupted (params, moments, head, losses)."""
    import shutil
    import tempfile

    import torch

    from repro_torch import configs, convert
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model as model_lib

    tr = TRAIN
    scfg = configs.get_config(arch, "smoke")
    sb, ss = tr["smoke_batch"], tr["smoke_seq"]
    s0 = model_lib.init_train_state(scfg, SEED, TrainConfig(), device)
    batch = _train_batch(scfg, 1, sb, ss, device)
    one, m1 = model_lib.train_step(convert.train_state_from_numpy(s0, scfg, device), batch, scfg)
    two, m2 = model_lib.train_step(convert.train_state_from_numpy(s0, scfg, device), batch, scfg)
    check(_leaf_digests(one) == _leaf_digests(two)
          and all(torch.equal(m1[k], m2[k]) for k in m1),
          f"{tag}: two train_steps from one state differ")
    del s0, one, two
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        kw = dict(steps=2 * tr["resume_at"], batch=sb, seq=ss, seed=SEED, log_every=100,
                  device=device)
        full, full_losses = train_lib.train(arch, "smoke", **kw)
        _, first = train_lib.train(arch, "smoke", **dict(
            kw, steps=tr["resume_at"], ckpt_dir=str(tmp), ckpt_every=tr["resume_at"]))
        resumed, rest = train_lib.train(arch, "smoke", **dict(
            kw, ckpt_dir=str(tmp), ckpt_every=tr["resume_at"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(_leaf_digests(resumed) == _leaf_digests(full) and first + rest == full_losses,
          f"{tag}: {tr['resume_at']} steps + resume to {2 * tr['resume_at']} differ from "
          f"{2 * tr['resume_at']} uninterrupted")
    print(f"  {tag} smoke width on the card ({arch}, B={sb}, S={ss}): two train_steps from one "
          f"state bit for bit; {tr['resume_at']} steps + resume to {2 * tr['resume_at']} == "
          f"{2 * tr['resume_at']} uninterrupted, bit for bit (params, moments, ODL state, "
          f"losses)")


def phase_train(device="cuda"):
    """6l: the training path at qwen3-4b's full width, then mamba2-780m's
    and recurrentgemma-9b's at 6 of its 38 layers (see the module
    docstring)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib

    t_phase = time.perf_counter()
    card = _card()
    torch.cuda.empty_cache()
    tr = TRAIN
    cfg = configs.get_config(tr["arch"], tr["variant"])
    tcfg = TrainConfig()
    b = tr["batch"]
    res = {"allocated_before": torch.cuda.memory_allocated()}
    with _ShapeLog() as log:
        # (a) the TrainState on the card, from the seed.
        t0 = time.perf_counter()
        state = model_lib.init_train_state(cfg, SEED, tcfg, device)
        _sync(device)
        res["build_s"] = time.perf_counter() - t0
        res["allocated_after_build"] = torch.cuda.memory_allocated()
        res["params"] = sum(t.numel() for t in _model_leaves(state.params))
        schema_count = layers.count_params(model_lib.build_schema(cfg))
        check(res["params"] == schema_count == tr["params"],
              f"train (a): {res['params']} params built, schema {schema_count}")
        tensor_bytes = 4 * res["params"]
        check(res["allocated_after_build"] - res["allocated_before"] >= 3 * tensor_bytes,
              f"train (a): {res['allocated_after_build']} bytes after the build")
        del state
        torch.cuda.empty_cache()
        print(f"training (6l, {tr['arch']} {tr['variant']}, {tcfg.param_dtype} master params, "
              f"remat {tcfg.remat}, lr {tcfg.learning_rate}, wd {tcfg.weight_decay}, clip "
              f"{tcfg.grad_clip}) on {card}: {res['allocated_before']} bytes allocated before "
              f"it; (a) {res['params']} parameters, allocator {res['allocated_after_build']} "
              f"bytes after the build against 3 x {tensor_bytes} (params, m, v), built in "
              f"{res['build_s']:.2f} s")

        # (b) launch.train.train at full width: B x S tokens a step, B ODL rows.
        res.update(_train_steps(tr["arch"], tr["variant"], device, card, "(b)"))

        # (c) smoke width on the card: replay and resume, bit for bit.
        _train_replay_resume(tr["arch"], device, "(c)")

        # (d) odl_update at n_in = d_model from a warm head built on the CPU:
        # rows prune; the card's decisions equal the CPU's.
        rng = np.random.default_rng(SEED)
        centers = 2.0 * rng.standard_normal((cfg.odl.n_out, cfg.d_model))
        odl = model_lib.init_odl_state(cfg, "cpu")
        for _ in range(tr["warm_calls"]):
            f, y = _clustered_feats(rng, b, centers)
            odl, _ = model_lib.odl_update(odl, torch.as_tensor(f), torch.as_tensor(y), cfg)
        check(int(odl.elm.count) >= 288 and int(odl.prune.level) > 0,
              f"train (d): the CPU's head is not warm: {odl.elm.count}, {odl.prune}")
        f, y = _clustered_feats(rng, b, centers, ambiguous=True)
        card_odl = model_lib.ODLState(*(type(g)(*(t.to(device) for t in g)) for g in odl))
        host, mh = model_lib.odl_update(odl, torch.as_tensor(f), torch.as_tensor(y), cfg)
        got, mc = model_lib.odl_update(card_odl, torch.as_tensor(f, device=device),
                                       torch.as_tensor(y, device=device), cfg)
        same = (all(round(float(mc[k]) * b) == round(float(mh[k]) * b)
                    for k in ("odl_query_frac", "odl_acc"))
                and float(mc["odl_theta"]) == float(mh["odl_theta"])
                and int(got.elm.count) == int(host.elm.count)
                and all(int(a) == int(c) for a, c in zip(got.prune, host.prune)))
        dp = (got.elm.P.cpu() - host.elm.P).abs().max().item() * cfg.odl.ridge
        db = (got.elm.beta.cpu() - host.elm.beta).abs().max().item()
        check(same and 0.0 < float(mh["odl_query_frac"]) < 1.0 and dp < 2e-5 and db < 2e-4,
              f"train (d): card {mc} against cpu {mh}, P {dp}, beta {db}")
        print(f"  (d) odl_update at n_in {cfg.d_model} from a warm head built on the CPU (count "
              f"{int(odl.elm.count)}, level {int(odl.prune.level)}): {round(float(mh['odl_query_frac']) * b)} "
              f"of {b} rows queried on both; decisions, count and PruneState exact; P "
              f"{dp:.2e} in units of I/ridge (< 2e-5), beta max |diff| {db:.2e} (< 2e-4)")

        # (e) the SSD stack at full width and (f) the hybrid stack at 6 of
        # its 38 layers, each as (b).
        for key, (arch, fam) in zip(("ssm", "hybrid"), TRAIN_FAMILIES.items()):
            fcfg, note = configs.get_config(arch, tr["variant"]), ""
            if fam["depth"] is not None:
                note = (f" at {fam['depth']} of its {fcfg.n_layers} layers (reduced: depth "
                        f"{fcfg.n_layers} -> {fam['depth']}, one card)")
                fcfg = fcfg.replace(n_layers=fam["depth"])
            res[key] = _train_steps(arch, tr["variant"], device, card, fam["tag"], cfg=fcfg,
                                    note=note)
            check(res[key]["params"] == fam["params"],
                  f"train {fam['tag']}: {res[key]['params']} params, want {fam['params']}")
    missing = log.missing()
    check(not missing, f"train: shapes phases 2-4 did not hold: {missing}")
    res["shapes"] = {k: sorted(v) for k, v in log.shapes.items() if v}
    res["seconds"] = time.perf_counter() - t_phase
    print(f"  kernel shapes on 6l's path, each held in phases 2-4: {res['shapes']}")
    for part, r in (("(b)", res), ("(e)", res["ssm"]), ("(f)", res["hybrid"])):
        print(f"  kernels on 6l's main path {part} (launches + replays): "
              + str({k: r['launches'].get(k, 0) + r['replays'].get(k, 0) for k in TRAIN_KERNELS}))
    print(f"  phase 6l took {res['seconds']:.1f} s ({card})")
    return res


# ---------------------------------------------------------------------------
# Phase 6o: whisper-small's encoder-decoder (models/encdec.py)
# ---------------------------------------------------------------------------


def _cut_encdec(params, cfg, depth):
    """The first ``depth`` encoder and decoder layers (views) and their
    config."""
    if depth == cfg.n_layers == cfg.n_enc_layers:
        return params, cfg
    cut = dict(params, enc_layers=_first_layers(params["enc_layers"], depth),
               dec_layers=_first_layers(params["dec_layers"], depth))
    return cut, cfg.replace(n_layers=depth, n_enc_layers=depth)


def _encdec_decode(params, cfg, caches, toks, device):
    """``encdec.decode_step`` over every token of ``toks`` (B, n) from
    position 0: the hidden states (B, n, d) and each step's ms (host clock,
    synchronised)."""
    import torch

    from repro_torch.models import encdec

    pos = torch.zeros((toks.shape[0],), dtype=torch.int32, device=toks.device)
    hs, ms = [], []
    for i in range(toks.shape[1]):
        _sync(device)
        t0 = time.perf_counter()
        h, caches = encdec.decode_step(params, toks[:, i:i + 1], caches, pos, cfg)
        _sync(device)
        ms.append(1e3 * (time.perf_counter() - t0))
        hs.append(h)
        pos = pos + 1
    return torch.cat(hs, 1), ms


def _profile_calls(fn, n, device):
    """``fn`` called ``n`` times under ``torch.profiler`` after one warm-up
    call: per call the device busy ms (every kernel and copy), the wall ms
    under the profiler, the device ops and the three costliest kernels."""
    import torch
    from torch.autograd import DeviceType

    fn()
    _sync(device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        _sync(device)
        wall = 1e3 * (time.perf_counter() - t0)
    work = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
            if e.device_type == DeviceType.CUDA]
    by_name = {}
    for name, dur in work:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + dur / 1e3 / n
    busy = sum(dur for _, dur in work) / 1e3
    return {"busy_ms": busy / n, "wall_ms": wall / n, "device_ops": len(work) / n,
            "busy_share": busy / wall if wall else float("nan"),
            "top": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:3])}


def _profile_text(p):
    return (f"device busy {p['busy_ms']:.2f} ms a call in {p['wall_ms']:.2f} wall "
            f"({100 * p['busy_share']:.1f} % busy), {p['device_ops']:.0f} device ops a call; "
            f"costliest {', '.join(f'{k} {v:.2f}' for k, v in p['top'].items())} ms")


def _encdec_vs_teacher(params, cfg, frames, toks, device):
    """6o (b) at one depth: ``encdec_prefill`` of ``frames``, then the decode
    of ``toks`` against ``decode_train``'s teacher-forced hidden over them;
    returns the excess over atol 0.15 / rtol 0.05 and the Frobenius and max
    abs differences."""
    from repro_torch.models import encdec
    from repro_torch.models import model as model_lib

    enc, caches = model_lib.encdec_prefill(params, frames, cfg, ENCDEC["max_len"])
    want = encdec.decode_train(params, toks, enc, cfg)
    got, _ = _encdec_decode(params, cfg, caches, toks, device)
    fro, mx = _fro_and_max(got, want)
    return {"excess": _within(got, want, 0.15, 0.05), "fro_rel": fro, "max_abs": mx}


def phase_encdec(device="cuda"):
    """6o: whisper-small's encoder-decoder at full width (see the module
    docstring)."""
    import torch

    from repro_torch import configs
    from repro_torch.models import encdec, layers
    from repro_torch.models import model as model_lib

    t_phase = time.perf_counter()
    card = _card()
    torch.cuda.empty_cache()
    ed = ENCDEC
    cfg = configs.get_config(ed["arch"], ed["variant"])
    b, t_frames, n_dec = ed["batch"], ed["frames"], ed["decode"]
    res = {"allocated_before": torch.cuda.memory_allocated()}
    print(f"encdec (6o, {ed['arch']} {ed['variant']}: {cfg.n_enc_layers} encoder and "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, attention {cfg.attention_impl}) on {card}: "
          f"{res['allocated_before']} bytes allocated before it")
    with _ShapeLog() as log:
        # (a) the serving params on the card from the seed; count them.
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model_lib.build_params(cfg, SEED, device)
        _sync(device)
        res["build_s"] = time.perf_counter() - t0
        res["build_peak_bytes"] = torch.cuda.max_memory_allocated()
        res["params"] = sum(t.numel() for t in _model_leaves(params))
        schema_count = layers.count_params(model_lib.build_schema(cfg))
        check(res["params"] == schema_count == ed["params"],
              f"encdec (a): {res['params']} params built, schema {schema_count}")
        print(f"  (a) {res['params']} parameters (count_params {schema_count}), built in "
              f"{res['build_s']:.2f} s, allocator peak {res['build_peak_bytes']} bytes")

        # (b) B streams of T frames encoded, n_dec tokens decoded.
        gen = torch.Generator().manual_seed(SEED)
        frames = torch.randn((b, t_frames, cfg.d_model), generator=gen).to(device)
        toks = torch.randint(0, cfg.vocab_size, (b, n_dec), generator=gen).to(device)
        depth = ed["bound_depth"]
        bounded = _encdec_vs_teacher(*_cut_encdec(params, cfg, depth), frames, toks, device)
        check(bounded["excess"] <= 0, f"encdec (b): at {depth} layers decode beyond "
                                      f"decode_train by {bounded}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _sync(device)
        t0 = time.perf_counter()
        enc, caches = model_lib.encdec_prefill(params, frames, cfg, ed["max_len"])
        _sync(device)
        res["prefill_s"] = time.perf_counter() - t0
        res["prefill_peak_bytes"] = torch.cuda.max_memory_allocated()
        check(tuple(enc.shape) == (b, t_frames, cfg.d_model)
              and bool(torch.isfinite(enc.float()).all()), "encdec (b): encoder states")
        res["cache_bytes"] = {k: sum(t.numel() * t.element_size() for t in _model_leaves({k: v}))
                              for k, v in caches.items()}
        clone = {k: ({n: a.clone() for n, a in v.items()} if isinstance(v, dict) else v.clone())
                 for k, v in caches.items()}
        want = encdec.decode_train(params, toks, enc, cfg)
        got, ms = _encdec_decode(params, cfg, caches, toks, device)
        again, _ = _encdec_decode(params, cfg, clone, toks, device)
        check(torch.equal(got, again) and all(torch.equal(caches["self"][k], clone["self"][k])
                                              for k in caches["self"]),
              "encdec (b): the replayed decode differs")
        check(bool(torch.isfinite(got.float()).all()), "encdec (b): decode not finite")
        fro, mx = _fro_and_max(got, want)
        res["b"] = {"bounded": bounded, "full": {"excess": _within(got, want, 0.15, 0.05),
                                                 "fro_rel": fro, "max_abs": mx}}
        res["decode_ms"] = _pcts(ms)
        pos = torch.full((b,), n_dec - 1, dtype=torch.int32, device=device)
        res["decode_profile"] = _profile_calls(
            lambda: encdec.decode_step(params, toks[:, -1:], clone, pos, cfg), 4, device)
        del enc, caches, clone, want, got, again, frames
        torch.cuda.empty_cache()
        full = res["b"]["full"]
        print(f"  (b) encdec_prefill of B={b} x {t_frames} frames (max_len {ed['max_len']}) in "
              f"{1e3 * res['prefill_s']:.1f} ms (host clock, synchronised), allocator peak "
              f"{res['prefill_peak_bytes']} bytes, caches {res['cache_bytes']} bytes; "
              f"{n_dec} decode_steps against decode_train's teacher-forced hidden: at {depth} "
              f"layers within atol 0.15, rtol 0.05 (excess {bounded['excess']:.4f}, Frobenius "
              f"rel {bounded['fro_rel']:.4f}, max abs {bounded['max_abs']:.4f}); through all "
              f"{cfg.n_layers} (printed) excess {full['excess']:.4f}, Frobenius rel "
              f"{full['fro_rel']:.4f}, max abs {full['max_abs']:.4f}; a decode replayed from "
              f"cloned caches bit for bit; decode ms per token at B={b} (host clock, "
              f"synchronised, eager) p50 {res['decode_ms']['p50']:.2f}, p95 "
              f"{res['decode_ms']['p95']:.2f}; profiled (4 tokens): "
              f"{_profile_text(res['decode_profile'])} ({card})")
        del params
        torch.cuda.empty_cache()

        # (c) training at full width as 6l (b), and two train_steps profiled;
        # (d) smoke width as 6l (c).
        res["train"] = _train_steps(ed["arch"], ed["variant"], device, card, "(c)")
        state = model_lib.init_train_state(cfg, SEED, device=device)
        batch = _train_batch(cfg, 1, TRAIN["batch"], TRAIN["seq"], device)
        res["train_profile"] = _profile_calls(
            lambda: model_lib.train_step(state, batch, cfg), 2, device)
        del state, batch
        torch.cuda.empty_cache()
        print(f"  (c) a train_step profiled (2 steps, B={TRAIN['batch']}, S={TRAIN['seq']}): "
              f"{_profile_text(res['train_profile'])} ({card})")
        _train_replay_resume(ed["arch"], device, "(d)")
    missing = log.missing()
    check(not missing, f"encdec: shapes phases 2-4 did not hold: {missing}")
    res["shapes"] = {k: sorted(v) for k, v in log.shapes.items() if v}
    res["seconds"] = time.perf_counter() - t_phase
    r = res["train"]
    print(f"  kernel shapes on 6o's path, each held in phases 2-4: {res['shapes']}")
    print(f"  kernels on 6o's main path (c) (launches + replays): "
          + str({k: r['launches'].get(k, 0) + r['replays'].get(k, 0) for k in TRAIN_KERNELS}))
    print(f"  phase 6o took {res['seconds']:.1f} s ({card})")
    return res


# ---------------------------------------------------------------------------
# Phase 6p: the MoE and MLA stacks' training path, expert parallelism and the
# model-side mesh (models/moe.py, models/attention.py, distributed/sharding.py,
# distributed/pipeline.py, runtime/checkpoint.py)
# ---------------------------------------------------------------------------


def _train_split(prof, n_steps, wall_ms):
    """6p (b): device ms a training step of the ODL head (every kernel and
    copy that starts inside a device-side span of ``train.head``, by name)
    and of the backbone (every other one: the forward, the backward, which
    autograd launches from its own thread, and AdamW), the backbone's six
    costliest kernels, and the device busy share of the window."""
    from torch.autograd import DeviceType

    spans, work = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name == "train.head":
            spans.append((e.time_range.start, e.time_range.end))
        elif not e.name.startswith("train."):
            work.append((e.name, e.time_range.start, e.time_range.end - e.time_range.start))
    head = {"projection": 0.0, "rls": 0.0, "rest_of_head": 0.0}
    backbone, backbone_ms = {}, 0.0
    for name, start, dur in work:
        if any(a <= start < b for a, b in spans):
            part = ("projection" if "proj_kernel" in name else "rls"
                    if "rls_single_kernel" in name else "rest_of_head")
            head[part] += dur / 1e3 / n_steps
        else:
            backbone_ms += dur / 1e3 / n_steps
            backbone[name[:80]] = backbone.get(name[:80], 0.0) + dur / 1e3 / n_steps
    busy = sum(dur for _, _, dur in work) / 1e3
    return {"backbone_ms": backbone_ms, "head_ms": sum(head.values()), "head": head,
            "backbone_top": dict(sorted(backbone.items(), key=lambda kv: -kv[1])[:6]),
            "annotated": bool(spans), "busy_ms": busy / n_steps, "wall_ms": wall_ms / n_steps,
            "busy_share": busy / wall_ms if wall_ms else float("nan")}


def _profile_train(state, cfg, tcfg, b, seq, device, card, tag):
    """6p (b), (d): two ``train_step``s of the trained state in a profiler
    window, after one more unprofiled; ``_train_split`` of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as model_lib

    batch = _train_batch(cfg, TRAIN["steps"] + 1, b, seq, device)
    model_lib.train_step(state, batch, cfg, tcfg)
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            model_lib.train_step(state, batch, cfg, tcfg)
        _sync(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    sp = _train_split(prof, 2, wall_ms)
    del prof, batch
    torch.cuda.empty_cache()
    if not sp["annotated"]:
        print(f"  {tag} the split: not measured (the profiler gave no device-side span of "
              "train.head)")
    print(f"  {tag} a train_step at B={b}, S={seq} (2 steps profiled): device ms backbone "
          f"{sp['backbone_ms']:.2f} (forward, backward, AdamW), ODL head {sp['head_ms']:.4f} "
          f"(projection {sp['head']['projection']:.4f}, RLS {sp['head']['rls']:.4f}, the rest "
          f"of the head {sp['head']['rest_of_head']:.4f}); device busy {sp['busy_ms']:.2f} of "
          f"{sp['wall_ms']:.2f} ms wall ({100 * sp['busy_share']:.1f} %) ({card})")
    print(f"      the backbone's six costliest kernels, device ms a step: "
          + "; ".join(f"{name} {v:.3f}" for name, v in sp["backbone_top"].items()))
    return {"profile": sp}


def _moe_train_arch(arch, mt, device, card):
    """6p (a)-(b) or (d): ``arch`` at full width and ``mt["depth"]`` layers
    with ``mt["param_dtype"]`` master params: the TrainState built on the
    card and counted, then 6l (b) at ``mt``'s batch x seq with its aux
    losses, and two steps profiled.  With ``experts_cut`` the routed experts
    are cut to that many where the state's estimate does not fit the card's
    free memory."""
    import torch

    from repro_torch import configs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib

    tcfg = TrainConfig(param_dtype=mt["param_dtype"])
    full = configs.get_config(arch, "full")
    cfg = full.replace(n_layers=mt["depth"])
    # Bytes a parameter: params and gradients in the master params' dtype,
    # m and v in f32.
    width = 4 if tcfg.param_dtype == "float32" else 2
    per_param = 2 * width + 8
    schema = model_lib.build_schema(cfg)
    n = layers.count_params(schema)
    largest = max(math.prod(leaf.shape) for _, leaf in layers._iter_leaves(schema))
    free, total = torch.cuda.mem_get_info()
    estimate = per_param * n + 3 * 4 * largest  # + the draw of the largest leaf in f32, twice
    cut = ""
    if "experts_cut" in mt and estimate > free:
        cfg = cfg.replace(n_experts=mt["experts_cut"])
        cut = (f"; routed experts {full.n_experts} -> {mt['experts_cut']}: the estimate "
               f"{estimate} bytes exceeds the {free} free")
        n = layers.count_params(model_lib.build_schema(cfg))
    else:
        check(n == mt["params"], f"{arch}: {n} parameters at depth {mt['depth']}")
    note = (f" at {mt['depth']} of its {full.n_layers} layers (reduced: depth {full.n_layers} "
            f"-> {mt['depth']}, one card{cut}), {tcfg.param_dtype} master params")
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = model_lib.init_train_state(cfg, SEED, tcfg, device)
    _sync(device)
    build_s = time.perf_counter() - t0
    after_build = torch.cuda.memory_allocated()
    built = sum(t.numel() for t in _model_leaves(state.params))
    check(built == n, f"{arch}: {built} params built, schema {n}")
    held = after_build - before
    state_bytes = (per_param - width) * n
    check(held >= state_bytes, f"{arch}: {held} bytes after the build against {state_bytes}")
    del state
    torch.cuda.empty_cache()
    tag = mt["tag"]
    build_tag = "(a)" if tag == "(b)" else tag
    print(f"  {build_tag} {arch} full{note}: {built} parameters "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads, "
          f"{'MLA' if cfg.use_mla else 'GQA'} attention, {cfg.n_experts} routed experts top-"
          f"{cfg.top_k} of d_ff {cfg.d_ff_expert} + {cfg.n_shared_experts} shared, vocab "
          f"{cfg.vocab_size}); the TrainState built on the card in {build_s:.2f} s, allocator "
          f"{after_build} bytes after the build ({held} for it; params, m and v "
          f"{state_bytes}); estimate with the gradients {per_param} x N = {per_param * n} "
          f"bytes; card memory {free} free of {total} ({card})")
    res = _train_steps(arch, "full", device, card, tag, cfg=cfg, note=note, tcfg=tcfg,
                       batch=mt["batch"], seq=mt["seq"],
                       after=lambda st, c, t: _profile_train(st, c, t, mt["batch"], mt["seq"],
                                                             device, card, tag))
    res.update(params=built, build_s=build_s, allocated_after_build=after_build,
               estimate=per_param * n, cut=cut)
    return res


def _entry(device):
    """The mesh entry of 6p's meshes: the card's first device."""
    return "cuda:0" if device == "cuda" else device


def _rows_repeated(batch):
    """``batch`` with every row the first row's."""
    return {k: v[:1].expand_as(v).contiguous() for k, v in batch.items()}


def _moe_ep(device, card):
    """6p (e): ``moe_block_ep`` on a (data, model) dev mesh of one card's
    entries against the dense block, in f32 with TF32 off; each token
    shard's dropped pairs at the default capacity; both blocks timed; two
    smoke-width ``train_step``s through it against the meshless ones."""
    import torch

    from repro_torch import configs, convert
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import layers, moe
    from repro_torch.models import model as model_lib

    d_, m_ = EP["mesh"]
    mesh = mesh_lib.make_dev_mesh(d_, m_, devices=[_entry(device)] * (d_ * m_))
    cfg = configs.get_config("deepseek-moe-16b", "full")
    nodrop = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    b, s = EP["x"]
    t = b * s
    p = layers.init_params(moe.moe_schema(cfg), SEED, device, dtype=torch.float32)
    x = torch.randn((b, s, cfg.d_model), generator=_gen(device, SEED + 21), device=device)
    tok_axes, n_split, t_loc, cap = moe.ep_layout(t, nodrop, mesh)
    check(tok_axes == ("data", "model") and n_split == d_ * m_, f"ep (e): layout {tok_axes}")
    y_dense, aux_dense = moe._moe_block_dense(x, p, nodrop)
    y_ep, aux_ep = moe.moe_block_ep(x, p, nodrop, mesh)
    shards = x.reshape(n_split, t_loc, -1)
    aux_shards = torch.stack([moe.route(xs, p["router"], nodrop)[3] for xs in shards]).mean()
    err = float((y_ep - y_dense).abs().max() / y_dense.abs().max())
    aux_err = abs(float(aux_ep) - float(aux_shards)) / abs(float(aux_shards))
    aux_vs_dense = abs(float(aux_ep) - float(aux_dense)) / abs(float(aux_dense))
    check(err <= 1e-5 and aux_err <= 1e-6 and aux_vs_dense <= 0.05,
          f"ep (e): y {err}, aux against the shards' mean {aux_err}, against dense "
          f"{aux_vs_dense}")
    del y_dense, y_ep
    # The default capacity: each token shard's dropped pairs.
    _, _, _, cap_d = moe.ep_layout(t, cfg, mesh)
    drops = [int((~moe.dispatch_slots(moe.route(xs, p["router"], cfg)[2], cfg.n_experts,
                                      cap_d)[2]).sum()) for xs in shards]
    dense_drop = int((~moe.dispatch_slots(moe.route(x.reshape(t, -1), p["router"], cfg)[2],
                                          cfg.n_experts, moe._capacity(cfg, t))[2]).sum())
    ep_ms = _call_ms(lambda: moe.moe_block_ep(x, p, cfg, mesh))
    dense_ms = _call_ms(lambda: moe._moe_block_dense(x, p, cfg))
    del p, x, shards
    torch.cuda.empty_cache()
    print(f"  (e) moe_block_ep on a {d_} x {m_} (data, model) mesh of cuda:0 entries, one "
          f"deepseek-moe-16b layer at full width, x ({b}, {s}, {cfg.d_model}) f32, TF32 off: at "
          f"capacity factor {nodrop.capacity_factor:.2f} (E/k: nothing drops) y within "
          f"{err:.2e} of max |y| of the dense block's (<= 1e-5); aux {float(aux_ep):.6f}, the "
          f"mean of the {n_split} token shards' aux losses within {aux_err:.1e} (<= 1e-6; the "
          f"reference's pmean), the whole batch's {float(aux_dense):.6f} within rtol "
          f"{aux_vs_dense:.4f} (the reference test's 0.05); at the default "
          f"{cfg.capacity_factor}: capacity {cap_d} a shard, pairs dropped per token shard "
          f"{drops} of {t_loc * cfg.top_k} (the dense block over all {t} tokens drops "
          f"{dense_drop}); block ms (CUDA events around single calls, median of 5) EP "
          f"{ep_ms:.2f}, dense {dense_ms:.2f}: one card, {d_ * m_} mesh entries, the exchanges "
          f"device-local, not a multi-GPU time ({card})")

    # Two smoke-width train_steps through the EP block, against the meshless.
    scfg = configs.get_config("deepseek-moe-16b", "smoke")
    scfg = scfg.replace(moe_impl="ep", capacity_factor=scfg.n_experts / scfg.top_k)
    host = convert.train_state_to_numpy(model_lib.init_train_state(scfg, SEED, TrainConfig(),
                                                                   device))
    meshed, plain = (convert.train_state_from_numpy(host, scfg, device) for _ in range(2))
    losses = []
    for step in (1, 2):
        batch = _rows_repeated(_train_batch(scfg, step, EP["smoke_batch"], EP["smoke_seq"],
                                            device))
        with sharding.activate(mesh):
            meshed, m_ep = model_lib.train_step(meshed, batch, scfg)
        plain, m_plain = model_lib.train_step(plain, batch, scfg)
        for key in ("loss", "grad_norm"):
            a, b_ = float(m_ep[key]), float(m_plain[key])
            check(abs(a - b_) <= 1e-5 * abs(b_), f"ep (e): step {step} {key} {a} against {b_}")
        losses.append((float(m_ep["loss"]), float(m_plain["loss"])))
    worst = max(float((a - b_).abs().max()) for a, b_ in
                zip(_model_leaves(meshed.params), _model_leaves(plain.params)))
    check(worst <= 1e-5, f"ep (e): params after two steps differ by {worst}")
    print(f"  (e) two smoke-width train_steps (B={EP['smoke_batch']}, S={EP['smoke_seq']}, one "
          f"sequence repeated, so that every token shard routes alike and the shards' mean aux "
          f"is the batch's; capacity factor E/k) with moe_impl='ep' under the mesh against the "
          f"same steps without it, f32: losses {losses} within 1e-5; params within {worst:.1e} "
          f"(<= 1e-5)")
    return {"err": err, "aux_err": aux_err, "aux_vs_dense": aux_vs_dense, "drops": drops,
            "dense_drop": dense_drop, "ep_ms": ep_ms, "dense_ms": dense_ms,
            "train_params_err": worst}


def _pipeline_check(device, card):
    """6p (f): ``pipeline_forward`` on a ("stage",) mesh of cuda:0 entries
    against ``sequential_reference``, f32 with TF32 off."""
    import torch

    from repro_torch.distributed import pipeline
    from repro_torch.launch import mesh as mesh_lib

    n, m, b = PIPE["stages"], PIPE["microbatches"], PIPE["batch"]
    mesh = mesh_lib.make_mesh((n,), ("stage",), devices=[_entry(device)] * n)
    errs = {}
    for d in PIPE["widths"]:
        gen = _gen(device, SEED + 22 + d)
        h = torch.randn((m, b, d), generator=gen, device=device)
        w = torch.randn((n, d, d), generator=gen, device=device) / math.sqrt(d)

        def stage_fn(x, p):
            return torch.tanh(x @ p["w"])

        got = pipeline.pipeline_forward(h, {"w": w}, stage_fn, mesh)
        want = pipeline.sequential_reference(h, {"w": w}, stage_fn, n)
        errs[d] = float((got - want).abs().max())
        check(tuple(got.shape) == (m, b, d) and errs[d] <= 1e-5, f"pipeline (f): d {d}, "
                                                                  f"max |diff| {errs[d]}")
    frac = pipeline.bubble_fraction(n, m)
    check(frac == 7 / 11, f"pipeline (f): bubble fraction {frac}")
    print(f"  (f) pipeline_forward on a ('stage',) mesh of {n} cuda:0 entries, {m} microbatches "
          f"of {b} rows, {n + m - 1} ticks: against sequential_reference max |diff| "
          + ", ".join(f"{v:.1e} at d {d}" for d, v in errs.items())
          + f" (<= 1e-5); bubble fraction {frac:.4f} = 7/11 ({card})")
    return errs


def _rescale_check(device, card):
    """6p (g): smoke params ``reshard_tree``d onto one dev mesh of cuda:0
    entries, saved, and ``rescale``d onto another: every shard bit for bit
    the slice its placement names, on its entry."""
    import shutil
    import tempfile

    import torch

    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib
    from repro_torch.runtime import checkpoint

    schema = model_lib.build_schema(configs.get_config(RESCALE["arch"], "smoke"))
    params = layers.init_params(schema, SEED, device)
    (da, ma), (db, mb) = RESCALE["meshes"]
    mesh_a = mesh_lib.make_dev_mesh(da, ma, devices=[_entry(device)] * (da * ma))
    mesh_b = mesh_lib.make_dev_mesh(db, mb, devices=[_entry(device)] * (db * mb))

    def slices_hold(tree, mesh, what):
        n_shards = split = 0
        for (path, sh), (_, whole) in zip(checkpoint._flatten(tree), checkpoint._flatten(params),
                                          strict=True):
            check(isinstance(sh, sharding.Sharded) and sh.placement.mesh == mesh, f"{what} {path}")
            index_map = sh.placement.indices_map(tuple(whole.shape))
            split += any(s != slice(None) for s in next(iter(index_map.values())))
            for pos, index in index_map.items():
                shard = sh.shards[pos]
                check(shard.device == torch.device(_entry(device))
                      and torch.equal(shard, whole[index]),
                      f"{what}: {path} at {pos} is not the slice its placement names")
                n_shards += 1
        return n_shards, split

    with sharding.activate(mesh_a):
        specs = layers.param_specs(schema)
    placed = checkpoint.reshard_tree(params, mesh_a, specs)
    shards_a, split_a = slices_hold(placed, mesh_a, "rescale (g) before")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_rescale_"))
    try:
        mgr = checkpoint.CheckpointManager(str(tmp), keep=1)
        mgr.save(1, placed)
        step, restored = checkpoint.rescale(mgr, schema, mesh_b)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(step == 1, f"rescale (g): restored step {step}")
    shards_b, split_b = slices_hold(restored, mesh_b, "rescale (g) after")
    leaves = sum(1 for _ in _model_leaves(params))
    print(f"  (g) {RESCALE['arch']} smoke params ({leaves} leaves) reshard_tree'd onto a "
          f"{da} x {ma} mesh of cuda:0 entries ({shards_a} shards, {split_a} leaves split), "
          f"saved, and rescale'd onto {db} x {mb} ({shards_b} shards, {split_b} leaves split): "
          f"every shard bit for bit the slice its placement names, on its entry ({card})")
    return {"shards": [shards_a, shards_b], "split": [split_a, split_b]}


def phase_moe_train(device="cuda"):
    """6p: the MoE and MLA stacks' training path, expert parallelism, the
    pipeline and the rescale (see the module docstring)."""
    import torch

    from repro_torch.models import layers

    t_phase = time.perf_counter()
    card = _card()
    torch.cuda.empty_cache()
    res = {"allocated_before": torch.cuda.memory_allocated()}
    print(f"moe training (6p: deepseek-moe-16b and deepseek-v2-236b at full width, cut in "
          f"depth; expert parallelism, the pipeline and the rescale on meshes of cuda:0 "
          f"entries) on {card}: {res['allocated_before']} bytes allocated before it")
    with _ShapeLog() as log:
        arch = "deepseek-moe-16b"
        res[arch] = _moe_train_arch(arch, MOE_TRAIN[arch], device, card)
        for arch in MOE_TRAIN:
            _train_replay_resume(arch, device, "(c)")
        arch = "deepseek-v2-236b"
        res[arch] = _moe_train_arch(arch, MOE_TRAIN[arch], device, card)
        saved = (layers.COMPUTE_DTYPE, torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        layers.COMPUTE_DTYPE = torch.float32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            res["ep"] = _moe_ep(device, card)
            res["pipeline"] = _pipeline_check(device, card)
        finally:
            (layers.COMPUTE_DTYPE, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
        res["rescale"] = _rescale_check(device, card)
    missing = log.missing()
    check(not missing, f"moe training: shapes phases 2-4 did not hold: {missing}")
    res["shapes"] = {k: sorted(v) for k, v in log.shapes.items() if v}
    res["seconds"] = time.perf_counter() - t_phase
    print(f"  kernel shapes on 6p's path, each held in phases 2-4: {res['shapes']}")
    for arch, mt in MOE_TRAIN.items():
        r = res[arch]
        print(f"  kernels on 6p's main path {mt['tag']} (launches + replays): "
              + str({k: r['launches'].get(k, 0) + r['replays'].get(k, 0) for k in TRAIN_KERNELS}))
    print(f"  phase 6p took {res['seconds']:.1f} s ({card})")
    return res


# ---------------------------------------------------------------------------
# Phase 6s: the dense stacks' training step over partitioned leaves
# (models/model.py partitioned_train_step) on a mesh of one card's entries
# ---------------------------------------------------------------------------


def _placement_checks(state, placements, metas, mesh):
    """6s (b): every param and moment a ``Sharded`` on its placement, each
    shard of its slice's shape on its entry; returns each position's bytes
    (params and moments) and the census's per-device bytes of the same."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun

    per_pos = {pos: 0 for pos in mesh.positions()}
    want = 0
    for tree, pls, mts in ((state.params, placements.params, metas.params),
                           (state.opt.m, placements.opt.m, metas.opt.m),
                           (state.opt.v, placements.opt.v, metas.opt.v)):
        for sh, pl, meta in zip(_model_leaves(tree), _model_leaves(pls), _model_leaves(mts)):
            check(isinstance(sh, sharding.Sharded) and sh.placement == pl,
                  f"partitioned (b): a leaf left its placement {pl.spec}")
            for pos, index in pl.indices_map(tuple(meta.shape)).items():
                t = sh.shards[pos]
                shape = tuple(len(range(*ix.indices(n))) for ix, n in zip(index, meta.shape))
                check(tuple(t.shape) == shape and t.device == mesh.device_at(pos),
                      f"partitioned (b): shard {pos} of {pl.spec} is {tuple(t.shape)} on "
                      f"{t.device}, want {shape}")
                per_pos[pos] += t.numel() * t.element_size()
            want += dryrun.device_bytes(meta, pl)
    return per_pos, want


def _leaf_errs(got, want, bf16):
    """Per tree (params, m, v) of two whole ``TrainState``s, the worst
    leaf's error: in f32 max |diff| (params) or max |diff| over max |want|
    (moments); in bf16 the worst of |diff| - 3e-2 |want| (the reference
    test's atol = rtol = 3e-2: at most 3e-2).  ``want``'s leaves may lie in
    host memory: each is moved to its ``got`` leaf's device in turn."""
    errs = {}
    for name in ("params", "m", "v"):
        a_tree = got.params if name == "params" else getattr(got.opt, name)
        b_tree = want.params if name == "params" else getattr(want.opt, name)
        worst = 0.0
        for a, b in zip(_model_leaves(a_tree), _model_leaves(b_tree)):
            b = b.to(a.device)
            if bf16:
                e = (a - b).abs() - 3e-2 * b.abs()
                worst = max(worst, float(e.max()))
            else:
                scale = 1.0 if name == "params" else float(b.abs().max().clamp_min(1e-30))
                worst = max(worst, float((a - b).abs().max()) / scale)
        errs[name] = worst
    return errs


def _meshless_steps(cfg, tcfg, device, pt):
    """``pt``'s steps of the meshless ``train_step`` from SEED: (state,
    metrics, s/step, allocator peak above the bytes held before them)."""
    import torch

    from repro_torch.models import model as model_lib

    state = model_lib.init_train_state(cfg, SEED, tcfg, device)
    metrics, seconds = [], []
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for step in range(1, pt["steps"] + 1):
        batch = _train_batch(cfg, step, pt["batch"], pt["seq"], device)
        _sync(device)
        t0 = time.perf_counter()
        state, m = model_lib.train_step(state, batch, cfg, tcfg)
        _sync(device)
        seconds.append(time.perf_counter() - t0)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return state, metrics, seconds, torch.cuda.max_memory_allocated() - held


def _partitioned_pair(cfg, tcfg, mesh, device, precision, card):
    """6s (a), (b), (d), (e) in one compute dtype: ``steps`` partitioned
    steps and as many meshless ones from one seeded state.  In f32 the
    leaves are also held to the meshless step's own spread: the same steps
    at two microbatches (another valid order of the gradients' sums)."""
    import dataclasses

    import torch

    from repro_torch.distributed import sharding
    from repro_torch.engine import graphs
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib

    pt = PARTITIONED
    bf16 = precision == "bf16"
    with sharding.activate(mesh):
        metas, placements = model_lib.abstract_train_state(cfg, tcfg)
    placed = model_lib.place_train_state(model_lib.init_train_state(cfg, SEED, tcfg, device),
                                         mesh, cfg, tcfg)
    torch.cuda.empty_cache()
    out = {"launches": {}, "replays": {}, "s_per_step": []}
    metrics = []
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for step in range(1, pt["steps"] + 1):
        batch = _train_batch(cfg, step, pt["batch"], pt["seq"], device)
        ops.reset_launch_counts()
        graphs.reset_replay_counts()
        _sync(device)
        t0 = time.perf_counter()
        with sharding.activate(mesh):
            placed, m = model_lib.train_step(placed, batch, cfg, tcfg)
        _sync(device)
        out["s_per_step"].append(time.perf_counter() - t0)
        got = {k: ops.launch_counts.get(k, 0) + graphs.kernel_replays.get(k, 0)
               for k in TRAIN_KERNELS}
        check(got == {"xorshift_projection": 2, "oselm_rls_update": 1},
              f"partitioned (d) {precision} step {step}: head kernels {got}")
        for src, key in ((ops.launch_counts, "launches"), (graphs.kernel_replays, "replays")):
            for k, v in src.items():
                out[key][k] = out[key].get(k, 0) + v
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        per_pos, want_bytes = _placement_checks(placed, placements, metas, mesh)
        check(set(per_pos.values()) == {want_bytes},
              f"partitioned (b) {precision} step {step}: bytes a position "
              f"{sorted(set(per_pos.values()))}, census {want_bytes}")
    out["held_bytes"], out["peak_bytes"] = held, torch.cuda.max_memory_allocated() - held
    out["position_bytes"] = want_bytes
    got_state = model_lib.gather_train_state(placed)
    del placed
    torch.cuda.empty_cache()
    whole, plain, out["plain_s_per_step"], out["plain_peak_bytes"] = _meshless_steps(
        cfg, tcfg, device, pt)
    if bf16:
        loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(metrics, plain))
        check(loss_err <= 2e-2, f"partitioned (a) bf16: losses {metrics} against {plain}")
    else:
        loss_err = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(metrics, plain)
                       for k in ("loss", "grad_norm"))
        check(loss_err <= 1e-5, f"partitioned (a) f32: {metrics} against {plain}")
    errs = _leaf_errs(got_state, whole, bf16)
    del got_state
    torch.cuda.empty_cache()
    if bf16:
        check(all(e <= 3e-2 for e in errs.values()), f"partitioned (a) bf16: leaves {errs}")
        rule = "leaves |diff| <= 3e-2 + 3e-2 |meshless|, the worst excess shown"
    else:
        mb2 = dataclasses.replace(tcfg, microbatches=2)
        other, other_m, _, _ = _meshless_steps(cfg, mb2, device, pt)
        floor = _leaf_errs(other, whole, False)
        del other
        torch.cuda.empty_cache()
        out["floor"] = floor
        out["floor_loss_err"] = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(other_m, plain)
                                    for k in ("loss", "grad_norm"))
        check(all(errs[k] <= 2 * floor[k] for k in errs),
              f"partitioned (a) f32: leaves {errs} against the meshless spread {floor}")
        rule = (f"within twice the meshless step's own spread at 2 microbatches: "
                f"{({k: f'{v:.2e}' for k, v in floor.items()})}, loss and grad norm "
                f"{out['floor_loss_err']:.2e}")
    del whole
    torch.cuda.empty_cache()
    out.update(metrics=metrics, plain_metrics=plain, loss_err=loss_err, leaf_errs=errs)
    print(f"  (a) {precision} compute{'' if bf16 else ' (TF32 off)'}: {pt['steps']} "
          f"partitioned steps {[round(x['loss'], 6) for x in metrics]} (grad norms "
          f"{[round(x['grad_norm'], 6) for x in metrics]}) against the meshless "
          f"{[round(x['loss'], 6) for x in plain]} ({[round(x['grad_norm'], 6) for x in plain]}): "
          f"worst relative {loss_err:.2e} (bound {'2e-2' if bf16 else '1e-5'}); leaves (params "
          f"max |diff|, moments max |diff| over max |meshless|) "
          f"{({k: f'{v:.2e}' for k, v in errs.items()})} ({rule})")
    print(f"  (b) {precision}: after each step every param and moment on its placement, each "
          f"shard its slice's shape on its entry; {out['position_bytes']} bytes a position "
          f"(params and moments) = the census's per-device argument bytes")
    print(f"  (e) {precision}: s/step partitioned {[round(x, 3) for x in out['s_per_step']]}, "
          f"meshless {[round(x, 3) for x in out['plain_s_per_step']]} (host clock, synchronised; "
          f"step 1 includes warm-up); allocator peak above the {out['held_bytes']} bytes held "
          f"before the steps: partitioned {out['peak_bytes']}, meshless "
          f"{out['plain_peak_bytes']} above its own (one card, {math.prod(pt['mesh'])} mesh "
          f"entries, exchanges device-local: not a multi-GPU time) ({card})")
    return out


def phase_partitioned(device="cuda"):
    """6s: qwen3-4b's training step on partitioned leaves at full width, on
    a (data, model) mesh of cuda:0 entries (see the module docstring)."""
    import torch

    from repro_torch import configs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import sharding
    from repro_torch.launch import census
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib

    t_phase = time.perf_counter()
    card = _card()
    pt = PARTITIONED
    torch.cuda.empty_cache()
    full = configs.get_config(pt["arch"], "full")
    cfg = full.replace(n_layers=pt["depth"])
    tcfg = TrainConfig()
    d, m = pt["mesh"]
    mesh = mesh_lib.make_dev_mesh(d, m, devices=[_entry(device)] * (d * m))
    res = {"allocated_before": torch.cuda.memory_allocated()}
    print(f"partitioned training (6s: {pt['arch']} at full width, {pt['depth']} of its "
          f"{full.n_layers} layers (reduced: depth {full.n_layers} -> {pt['depth']}, two f32 "
          f"training states on one card), B={pt['batch']}, S={pt['seq']}, f32 master params, "
          f"remat {tcfg.remat}, on a {d} x {m} (data, model) mesh of cuda:0 entries) on {card}: "
          f"{res['allocated_before']} bytes allocated before it")
    with _ShapeLog() as log:
        saved = (layers.COMPUTE_DTYPE, torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        layers.COMPUTE_DTYPE = torch.float32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            res["f32"] = _partitioned_pair(cfg, tcfg, mesh, device, "f32", card)
        finally:
            (layers.COMPUTE_DTYPE, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
        res["bf16"] = _partitioned_pair(cfg, tcfg, mesh, device, "bf16", card)

        # (c) one more step under a census: the exchanges against the count.
        placed = model_lib.place_train_state(
            model_lib.init_train_state(cfg, SEED, tcfg, device), mesh, cfg, tcfg)
        batch = _train_batch(cfg, 1, pt["batch"], pt["seq"], device)
        with sharding.activate(mesh), census.StepCensus() as c:
            model_lib.train_step(placed, batch, cfg, tcfg)
        got = census.collective_census(c)
        want = census.partitioned_train_exchanges(cfg, tcfg, mesh, pt["batch"], pt["seq"])
        check(got == want, f"partitioned (c): exchanges {got} against {want}")
        res["exchanges"] = got
        del placed
        torch.cuda.empty_cache()
        print(f"  (c) one bf16 step under a census: {json.dumps(got)}, equal to "
              f"census.partitioned_train_exchanges by kind, count and bytes ({card})")
    missing = log.missing()
    check(not missing, f"partitioned: shapes phases 2-4 did not hold: {missing}")
    res["shapes"] = {k: sorted(v) for k, v in log.shapes.items() if v}
    res["launches"], res["replays"] = {}, {}
    for prec in ("f32", "bf16"):
        for key in ("launches", "replays"):
            for k, v in res[prec][key].items():
                res[key][k] = res[key].get(k, 0) + v
    res["seconds"] = time.perf_counter() - t_phase
    print(f"  (d) kernel shapes on 6s's path, each held in phases 2-4: {res['shapes']}; "
          f"launches + replays over the {2 * pt['steps']} partitioned steps: "
          + str({k: res['launches'].get(k, 0) + res['replays'].get(k, 0)
                 for k in TRAIN_KERNELS}) + f" (2 and 1 a step)")
    print(f"  phase 6s took {res['seconds']:.1f} s ({card})")
    return res


# ---------------------------------------------------------------------------
# Phase 6t: the DeepSeek stacks' training step over partitioned leaves
# (models/moe.py moe_block_tp, attention.py mla_attention_tp) on a mesh of
# one card's entries
# ---------------------------------------------------------------------------


def _placed_state(cfg, tcfg, mesh, device, params=None):
    """``init_train_state(cfg, SEED, tcfg, device)`` laid out on ``mesh`` by
    ``place_train_state``, with no whole state held on the card beside the
    placed one: the params (or ``params``, host tensors of the same draw)
    from host memory, the zero moments from one zero element expanded."""
    import torch

    from repro_torch.models import model as model_lib
    from repro_torch.optim import adam

    odl = model_lib.init_odl_state(cfg, device)
    if params is None:
        params = _host_params(model_lib.init_train_state(cfg, SEED, tcfg, device).params)
        torch.cuda.empty_cache()
    zero = torch.zeros((), dtype=torch.float32, device=device)
    moments = model_lib._map(lambda p: zero.expand(p.shape), params)
    state = model_lib.TrainState(
        params=params, odl=odl, opt=adam.AdamState(
            step=torch.zeros((), dtype=torch.int32, device=device), m=moments,
            v=model_lib._map(lambda p: zero.expand(p.shape), params)))
    return model_lib.place_train_state(state, mesh, cfg, tcfg)


def _host_params(params):
    return {k: _host_params(v) if isinstance(v, dict) else v.cpu() for k, v in params.items()}


class _RouteLog:
    """While active, notes each MoE block call's router probabilities
    (``moe.route``) and kept pairs (``moe._combine``) in call order: the
    token shards of a layer in token order."""

    def __enter__(self):
        from repro_torch.models import moe

        self.routes, self.keep = [], []
        self._saved = (moe.route, moe._combine)
        route, combine = self._saved

        def logged_route(xt, router, cfg):
            out = route(xt, router, cfg)
            self.routes.append(out[0].detach().clone())
            return out

        def logged_combine(out_e, flat_e, pos, keep, gate_k, dtype):
            self.keep.append(keep.detach().clone())
            return combine(out_e, flat_e, pos, keep, gate_k, dtype)

        moe.route, moe._combine = logged_route, logged_combine
        return self

    def take(self, n_layers, remat=False):
        """[(probs (T, E), kept (T k,)) per layer] of the calls so far: the
        forward's, the first half where remat recomputed every layer."""
        import torch

        routes, keep = self.routes, self.keep
        self.routes, self.keep = [], []
        if not routes:
            return []
        if remat:
            routes, keep = routes[:len(routes) // 2], keep[:len(keep) // 2]
        return [(torch.cat(routes[j * len(routes) // n_layers:(j + 1) * len(routes) // n_layers]),
                 torch.cat(keep[j * len(keep) // n_layers:(j + 1) * len(keep) // n_layers]))
                for j in range(n_layers)]

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route, moe._combine = self._saved


def _kept_pairs_equal(got, want, k, what):
    """6t (a): each layer's kept pairs of the first step against the step
    held to, on the tokens before the first whose router gap (k-th against
    (k+1)-th probability, from ``want``'s router) is not past 1e-5, whose
    slots do not depend on where that token routes.  Returns (tokens held,
    tokens, pairs dropped, all pairs equal) per layer."""
    import torch

    out = []
    for layer, ((_, gk), (wp, wk)) in enumerate(zip(got, want)):
        top = torch.sort(wp.double(), dim=-1, descending=True).values
        unclear = torch.nonzero(top[:, k - 1] - top[:, k] <= 1e-5)
        n = wp.shape[0] if not len(unclear) else int(unclear[0, 0])
        check(gk.shape == wk.shape and torch.equal(gk[:n * k], wk[:n * k]),
              f"partitioned moe (a) {what}: layer {layer}'s kept pairs differ on clear tokens")
        out.append((n, wp.shape[0], int((~wk).sum()), bool(torch.equal(gk, wk))))
    return out


def _run_train(state, cfg, tcfg, pt, device, scope=None, placements=None, reverse=False,
               what="", log=None):
    """``pt["steps"]`` train_steps (from step ``pt["first"]``, default 1)
    from ``state`` under the mesh ``scope``
    (None: no mesh), each batch's rows reversed where ``reverse``: (state,
    metrics, s/step, allocator peak above the bytes held before them,
    launches + replays of the head's kernels; with ``log``, a ``_RouteLog``,
    each step's routing by layer).  With ``placements`` ((metas,
    Placements) of a partitioned state) each step is held to 2 projections
    and 1 kernel-3 update and each position's bytes to the census's."""
    import contextlib

    import torch

    from repro_torch.distributed import sharding
    from repro_torch.engine import graphs
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib

    metrics, seconds, launches, routing = [], [], {}, None
    if log is not None:
        log.take(1)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    first = pt.get("first", 1)
    for step in range(first, first + pt["steps"]):
        batch = _train_batch(cfg, step, pt["batch"], pt["seq"], device)
        if reverse:
            batch = {k: v.flip(0) for k, v in batch.items()}
        ops.reset_launch_counts()
        graphs.reset_replay_counts()
        _sync(device)
        t0 = time.perf_counter()
        with sharding.activate(scope) if scope is not None else contextlib.nullcontext():
            state, m = model_lib.train_step(state, batch, cfg, tcfg)
        _sync(device)
        seconds.append(time.perf_counter() - t0)
        if log is not None:
            routing = (routing or []) + [log.take(cfg.n_layers, tcfg.remat)]
        got = {k: ops.launch_counts.get(k, 0) + graphs.kernel_replays.get(k, 0)
               for k in TRAIN_KERNELS}
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        if placements is not None:
            check(got == {"xorshift_projection": 2, "oselm_rls_update": 1},
                  f"partitioned moe (e) {what} step {step}: head kernels {got}")
            per_pos, want_bytes = _placement_checks(state, placements[1], placements[0], scope)
            check(set(per_pos.values()) == {want_bytes},
                  f"partitioned moe (c) {what} step {step}: bytes a position "
                  f"{sorted(set(per_pos.values()))}, census {want_bytes}")
    return dict(state=state, metrics=metrics, s_per_step=seconds, held_bytes=held,
                peak_bytes=torch.cuda.max_memory_allocated() - held, launches=launches,
                position_bytes=want_bytes if placements is not None else None, routing=routing)


def _permute_sums(state, cfg, axes, inverse=False):
    """``state`` (params and moments) with every dim of logical axis in
    ``axes`` permuted by a fixed permutation from SEED, one for each (axis,
    size), in place of the leaves (``inverse``: back): the same function
    with the sums over those dims in another order.  "embed" permutes the
    residual stream's basis (every product contracting over d_model, and
    rmsnorm's mean); "heads" the attention heads, q, k, v and wo alike (the
    arch has as many kv heads as q heads); "mlp" the experts' d_ff, whose
    partial products TP sums over "model"; "experts" the experts' order."""
    import torch

    from repro_torch.models import layers
    from repro_torch.models import model as model_lib

    if cfg.n_kv_heads != cfg.n_heads or cfg.use_mla:
        raise ValueError(f"{cfg.arch_id}: heads permute alike only without grouping or MLA")
    gen = torch.Generator().manual_seed(SEED)
    perms = {}
    for path, leaf in layers._iter_leaves(model_lib.build_schema(cfg)):
        for dim, (ax, n) in enumerate(zip(leaf.axes, leaf.shape)):
            ax = "heads" if ax == "kv_heads" else ax
            if ax not in axes:
                continue
            if (ax, n) not in perms:
                perms[ax, n] = torch.randperm(n, generator=gen)
            perm = perms[ax, n] if not inverse else torch.argsort(perms[ax, n])
            for tree in (state.params, state.opt.m, state.opt.v):
                sub = model_lib._at(tree, path[:-1])
                sub[path[-1]] = sub[path[-1]].index_select(dim, perm.to(sub[path[-1]].device))
    return state


# 6t (a): the dims whose sums the reference step's own spread reorders (the
# residual stream's basis, the heads and the experts' d_ff: the sums TP
# splits over "model").
SPREAD_AXES = ("embed", "heads", "mlp")


def _worst_leaves(got, want):
    """{tree: (leaf path, its error)} of the leaf with the largest error in
    each of params, m and v (``_leaf_errs``' measure, f32)."""
    from repro_torch.optim import adam

    out = {}
    for name in ("params", "m", "v"):
        a = got.params if name == "params" else getattr(got.opt, name)
        b = want.params if name == "params" else getattr(want.opt, name)
        errs = []
        for path, x, y in zip(adam._paths(a), adam.leaves(a), adam.leaves(b)):
            scale = 1.0 if name == "params" else float(y.abs().max().clamp_min(1e-30))
            errs.append((float((x - y).abs().max()) / scale, "/".join(path)))
        e, path = max(errs)
        out[name] = (path, f"{e:.2e}")
    return out


def _rel_errs(metrics, want):
    return max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(metrics, want)
               for k in ("loss", "grad_norm"))


def _clone_state(state):
    from repro_torch.models import model as model_lib

    return model_lib._map_path(lambda _, t: t.clone(), state)


def _moe_partitioned_f32(base, tcfg, mesh, device, card, res):
    """6t (a), (c), (d), (e), (f): deepseek-moe-16b under "dense" and "ep",
    each step from the reference step's state before it (AdamW turns a
    gradient near its 1e-8 eps into a move of a good part of lr, so two
    steps chained compound any rounding, most in the router's 0.02-scale
    weights)."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.launch import census
    from repro_torch.models import model as model_lib

    pt = dict(PARTITIONED_MOE["moe"], steps=1)
    even = base.replace(capacity_factor=base.n_experts / base.top_k)
    log = _RouteLog()
    for impl in ("dense", "ep"):
        cfg = base.replace(moe_impl=impl)
        scope = mesh if impl == "ep" else None
        ref_name = "the meshless step" if impl == "dense" else "the whole-tensor EP step"
        with sharding.activate(mesh):
            metas, placements = model_lib.abstract_train_state(cfg, tcfg)
        state = model_lib.init_train_state(cfg, SEED, tcfg, device)
        out = dict(metrics=[], ref_metrics=[], s_per_step=[], ref_s_per_step=[], peak_bytes=[],
                   ref_peak_bytes=[], held_bytes=[], leaf_errs=[], spreads=[], kept=[],
                   launches={})
        for step in range(1, PARTITIONED_MOE["steps"] + 1):
            one = dict(pt, first=step)
            with log:
                ref = _run_train(_clone_state(state), cfg, tcfg, one, device, scope=scope,
                                 log=log)
            want = ref.pop("state")
            # The reference step's own spread: the same step with its sums in
            # another valid order, against it: (i) the meshless step at
            # capacity factor E/k (no pair drops, so a token's output does not
            # depend on the others) on the batch's rows reversed against in
            # order; (ii) the step with the SPREAD_AXES dims permuted.
            a = _run_train(_clone_state(state), even, tcfg, one, device)
            in_order = model_lib._map_path(lambda _, t: t.cpu(), a.pop("state"))
            del a
            torch.cuda.empty_cache()
            b = _run_train(_clone_state(state), even, tcfg, one, device, reverse=True)
            spreads = {"rows reversed": _leaf_errs(b["state"], in_order, False)}
            del in_order, b
            torch.cuda.empty_cache()
            q = _run_train(_permute_sums(_clone_state(state), cfg, SPREAD_AXES), cfg, tcfg, one,
                           device, scope=scope)
            spreads["sums permuted"] = _leaf_errs(
                _permute_sums(q.pop("state"), cfg, SPREAD_AXES, inverse=True), want, False)
            del q
            torch.cuda.empty_cache()
            floor = {k: max(e[k] for e in spreads.values()) for k in ("params", "m", "v")}
            placed = model_lib.place_train_state(state, mesh, cfg, tcfg)
            del state
            torch.cuda.empty_cache()
            with log:
                part = _run_train(placed, cfg, tcfg, one, device, scope=mesh,
                                  placements=(metas, placements), what=impl, log=log)
            del placed
            got = model_lib.gather_train_state(part["state"])
            if step == PARTITIONED_MOE["steps"]:
                # (d) one more step under a census: the exchanges against
                # the count.
                batch = _train_batch(cfg, step + 1, pt["batch"], pt["seq"], device)
                with sharding.activate(mesh), census.StepCensus() as c:
                    model_lib.train_step(part["state"], batch, cfg, tcfg)
                exchanges = census.collective_census(c)
                count = census.partitioned_train_exchanges(cfg, tcfg, mesh, pt["batch"],
                                                           pt["seq"])
                check(exchanges == count,
                      f"partitioned moe (d) {impl}: exchanges {exchanges} against {count}")
            del part["state"]
            torch.cuda.empty_cache()
            loss_err = _rel_errs(part["metrics"], ref["metrics"])
            errs = _leaf_errs(got, want, False)
            worst = _worst_leaves(got, want)
            del got
            torch.cuda.empty_cache()
            held = _kept_pairs_equal(part["routing"][0], ref["routing"][0], cfg.top_k,
                                     f"{impl} step {step}")
            check(loss_err <= 1e-5, f"partitioned moe (a) {impl} step {step}: "
                  f"{part['metrics']} against {ref['metrics']}")
            check(all(errs[k] <= 2 * floor[k] for k in errs),
                  f"partitioned moe (a) {impl} step {step}: leaves {errs} against the spread "
                  f"{spreads}")
            print(f"  (a) {impl} step {step} (from {ref_name}'s state): loss "
                  f"{part['metrics'][0]['loss']:.6f}, grad norm "
                  f"{part['metrics'][0]['grad_norm']:.6f} against {ref_name}'s "
                  f"{ref['metrics'][0]['loss']:.6f}, {ref['metrics'][0]['grad_norm']:.6f}: worst "
                  f"relative {loss_err:.2e} (bound 1e-5); leaves (params max |diff|, moments "
                  f"over max |ref|) {({k: f'{v:.2e}' for k, v in errs.items()})}, worst "
                  f"{worst}, against twice the spread "
                  + "; ".join(f"{how} {({k: f'{v:.2e}' for k, v in e.items()})}"
                              for how, e in spreads.items())
                  + f"; kept pairs equal on (tokens held, tokens, pairs dropped, all equal) "
                  f"{held} by layer (held: the tokens before the first whose router gap is not "
                  f"past 1e-5)")
            for key, src in (("metrics", part["metrics"]), ("ref_metrics", ref["metrics"]),
                             ("s_per_step", part["s_per_step"]),
                             ("ref_s_per_step", ref["s_per_step"])):
                out[key] += src
            out["peak_bytes"].append(part["peak_bytes"])
            out["ref_peak_bytes"].append(ref["peak_bytes"])
            out["held_bytes"].append(part["held_bytes"])
            out["leaf_errs"].append(errs)
            out["spreads"].append(spreads)
            out["kept"].append(held)
            for k, v in part["launches"].items():
                out["launches"][k] = out["launches"].get(k, 0) + v
            state = want
        del state
        torch.cuda.empty_cache()
        print(f"  (c) {impl}: after each step every param and moment on its placement; "
              f"{part['position_bytes']} bytes a position = the census's")
        print(f"  (d) {impl}: one step under a census: {json.dumps(exchanges)}, equal to "
              f"census.partitioned_train_exchanges by kind, count and bytes")
        print(f"  (f) {impl}: s/step partitioned {[round(x, 3) for x in out['s_per_step']]}, "
              f"{ref_name} {[round(x, 3) for x in out['ref_s_per_step']]} (host clock, "
              f"synchronised; step 1 includes warm-up); allocator peak above the bytes held "
              f"before each step: partitioned {out['peak_bytes']} (above {out['held_bytes']}), "
              f"{ref_name} {out['ref_peak_bytes']}")
        out["exchanges"] = exchanges
        res[impl] = out


def _mla_partitioned_bf16(cfg, tcfg, mesh, device, card, res):
    """6t (b), (c), (e): deepseek-v2-236b at 1 layer, bf16 params, the
    meshless step first (two states do not fit the card)."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.models import model as model_lib

    pt = dict(PARTITIONED_MOE["mla"], steps=PARTITIONED_MOE["steps"])
    state = model_lib.init_train_state(cfg, SEED, tcfg, device)
    params = _host_params(state.params)  # the same draw for the partitioned state

    def kept(tree):  # the MLA and router leaves, on the host
        lay = tree["layers"]
        return {**{f"attn/{k}": v.float().cpu() for k, v in lay["attn"].items()},
                "moe/router": lay["moe"]["router"].float().cpu()}

    whole = _run_train(state, cfg, tcfg, pt, device)
    del state
    want = kept(whole.pop("state").params)
    torch.cuda.empty_cache()
    with sharding.activate(mesh):
        metas, placements = model_lib.abstract_train_state(cfg, tcfg)
    placed = _placed_state(cfg, tcfg, mesh, device, params=params)
    del params
    part = _run_train(placed, cfg, tcfg, pt, device, scope=mesh, placements=(metas, placements),
                      what="mla")
    del placed
    state = part.pop("state")
    got = {f"attn/{k}": v.gather().float().cpu()
           for k, v in state.params["layers"]["attn"].items()}
    got["moe/router"] = state.params["layers"]["moe"]["router"].gather().float().cpu()
    del state
    torch.cuda.empty_cache()
    loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(part["metrics"], whole["metrics"]))
    excess = max(float(((got[k] - want[k]).abs() - 3e-2 - 3e-2 * want[k].abs()).max())
                 for k in want)
    check(loss_err <= 2e-2, f"partitioned moe (b): losses {part['metrics']} against "
          f"{whole['metrics']}")
    check(excess <= 0, f"partitioned moe (b): the MLA and router leaves exceed 3e-2 + 3e-2 "
          f"|meshless| by {excess}")
    print(f"  (b) {cfg.arch_id}: {pt['steps']} partitioned steps "
          f"{[round(x['loss'], 6) for x in part['metrics']]} (grad norms "
          f"{[round(x['grad_norm'], 6) for x in part['metrics']]}) against the meshless "
          f"{[round(x['loss'], 6) for x in whole['metrics']]} "
          f"({[round(x['grad_norm'], 6) for x in whole['metrics']]}): loss worst relative "
          f"{loss_err:.2e} (bound 2e-2); the MLA and router leaves' worst |diff| - 3e-2 - 3e-2 "
          f"|meshless| {excess:.2e} (at most 0)")
    print(f"  (c) {cfg.arch_id}: after each step every param and moment on its placement; "
          f"{part['position_bytes']} bytes a position = the census's")
    print(f"  (f) {cfg.arch_id}: s/step partitioned {[round(x, 3) for x in part['s_per_step']]}, "
          f"meshless {[round(x, 3) for x in whole['s_per_step']]}; allocator peak above the "
          f"bytes held before the steps: partitioned {part['peak_bytes']} (above "
          f"{part['held_bytes']}), meshless {whole['peak_bytes']} (above {whole['held_bytes']})")
    res["mla"] = dict(metrics=part["metrics"], ref_metrics=whole["metrics"], loss_err=loss_err,
                      excess=excess, s_per_step=part["s_per_step"],
                      ref_s_per_step=whole["s_per_step"], peak_bytes=part["peak_bytes"],
                      ref_peak_bytes=whole["peak_bytes"], held_bytes=part["held_bytes"],
                      launches=part["launches"])


def phase_partitioned_moe(device="cuda"):
    """6t: the DeepSeek stacks' training step on partitioned leaves at full
    width, on a (data, model) mesh of cuda:0 entries (see the module
    docstring)."""
    import torch

    from repro_torch import configs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import layers

    t_phase = time.perf_counter()
    card = _card()
    torch.cuda.empty_cache()
    d, m = PARTITIONED_MOE["mesh"]
    mesh = mesh_lib.make_dev_mesh(d, m, devices=[_entry(device)] * (d * m))
    pm, pl = PARTITIONED_MOE["moe"], PARTITIONED_MOE["mla"]
    moe_full, mla_full = (configs.get_config(x["arch"], "full") for x in (pm, pl))
    res = {"allocated_before": torch.cuda.memory_allocated()}
    print(f"partitioned moe training (6t: {pm['arch']} at full width, B={pm['batch']}, "
          f"S={pm['seq']}, f32 state and compute (TF32 off), moe_impl dense and ep; "
          f"{pl['arch']} at full width, B={pl['batch']}, S={pl['seq']}, bf16 params, f32 "
          f"moments (reduced: depth {moe_full.n_layers} -> {pm['depth']} and "
          f"{mla_full.n_layers} -> {pl['depth']}, one card); remat, on a {d} x {m} (data, model) "
          f"mesh of cuda:0 entries: one device, no NVLink, every exchange a device-local copy) "
          f"on {card}: {res['allocated_before']} bytes allocated before it")
    with _ShapeLog() as log:
        saved = (layers.COMPUTE_DTYPE, torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        layers.COMPUTE_DTYPE = torch.float32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            _moe_partitioned_f32(moe_full.replace(n_layers=pm["depth"]), TrainConfig(), mesh,
                                 device, card, res)
        finally:
            (layers.COMPUTE_DTYPE, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
        _mla_partitioned_bf16(mla_full.replace(n_layers=pl["depth"]),
                              TrainConfig(param_dtype="bfloat16"), mesh, device, card, res)
    missing = log.missing()
    check(not missing, f"partitioned moe: shapes phases 2-4 did not hold: {missing}")
    res["shapes"] = {k: sorted(v) for k, v in log.shapes.items() if v}
    res["launches"] = {}
    for key in ("dense", "ep", "mla"):
        for k, v in res[key]["launches"].items():
            res["launches"][k] = res["launches"].get(k, 0) + v
    res["seconds"] = time.perf_counter() - t_phase
    print(f"  (e) kernel shapes on 6t's path, each held in phases 2-4: {res['shapes']}; "
          f"launches + replays over the {3 * PARTITIONED_MOE['steps']} compared partitioned "
          f"steps: " + str(res["launches"]) + " (2 and 1 a step)")
    print(f"  phase 6t took {res['seconds']:.1f} s ({card})")
    return res


# ---------------------------------------------------------------------------
# Phase 6q: the dry-run census (launch/census.py, launch/dryrun.py) on the
# card and on the meta device
# ---------------------------------------------------------------------------


def _census_sweep_child(arch: str, device_bytes: int) -> int:
    """``--census-sweep``: 6q (d)'s cells of one arch, one JSON line each,
    on the meta device (this process never touches the card)."""
    import torch

    from repro_torch import configs
    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    for shape in configs.LM_SHAPES:
        try:
            rec = dryrun.run_cell(arch, shape.name, False, device_bytes_limit=device_bytes)
        except Exception as e:  # noqa: BLE001 — reported, and 6q fails on it
            rec = {"arch": arch, "shape": shape.name, "status": "error",
                   "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(rec), flush=True)
    print(json.dumps({"sweep_seconds": time.perf_counter() - t0}), flush=True)
    return 0


def _start_census_sweep():
    """6q (d): one process a family (the host's cores run them side by side
    while 6p, 6s and 6q (a)-(c) hold the card), none touching the card
    (``CUDA_VISIBLE_DEVICES`` empty), one thread each.  Returns the device
    memory they hold the cells against and, by arch, (process, output
    file)."""
    import atexit
    import os
    import tempfile

    import torch

    total = torch.cuda.get_device_properties(0).total_memory
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = {}
    for arch in CENSUS["families"]:
        out, err = tempfile.TemporaryFile(mode="w+"), tempfile.TemporaryFile(mode="w+")
        procs[arch] = (subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--census-sweep", arch, str(total)],
            stdout=out, stderr=err, text=True, env=env), out, err)
    atexit.register(lambda: [p.kill() for p, _, _ in procs.values() if p.poll() is None])
    return total, procs


def _census_card_checks(tag, r, card):
    """6q (a), (b): the census's arguments against the allocator's, its
    peak against the step's, the card's census against meta's."""
    slack = CENSUS["leaf_bytes"] * r["n_leaves"]
    over = r["allocated_bytes"] - r["argument_bytes"]
    check(0 <= over <= slack, f"census {tag}: allocator {r['allocated_bytes']} bytes for the "
                              f"arguments against the census's {r['argument_bytes']} "
                              f"({r['n_leaves']} leaves, at most {slack} of rounding)")
    if r["requested_bytes"] is not None:
        check(r["requested_bytes"] == r["argument_bytes"],
              f"census {tag}: the allocator was asked for {r['requested_bytes']} bytes, "
              f"the census counts {r['argument_bytes']}")
    predicted = r["argument_bytes"] + r["temp_bytes"]
    rel = (predicted - r["peak_allocated_bytes"]) / r["peak_allocated_bytes"]
    check(abs(rel) <= CENSUS["peak_rtol"],
          f"census {tag}: arguments + live peak {predicted} bytes against the step's allocator "
          f"peak {r['peak_allocated_bytes']} ({100 * rel:+.2f} %)")
    check(r["census_equal"], f"census {tag}: the card's census differs from meta's: FLOPs "
                             f"{r['flops_card']} / {r['flops_meta']}, bytes {r['bytes_card']} / "
                             f"{r['bytes_meta']}; first difference {r['first_difference']}")
    print(f"  {tag} arguments: census {r['argument_bytes']} bytes in {r['n_leaves']} leaves; "
          f"allocator {r['allocated_bytes']} (+{over} in 512-byte blocks), asked "
          f"{r['requested_bytes']}; live peak {r['temp_bytes']} (on the card's census "
          f"{r['card_temp_bytes']}); arguments + live peak {predicted} against the step's "
          f"allocator peak {r['peak_allocated_bytes']} ({100 * rel:+.2f} %, limit "
          f"{100 * CENSUS['peak_rtol']:.0f} %); census on the card == on meta: FLOPs "
          f"{r['flops_card']}, bytes {r['bytes_card']}; entry points {r['kernel_calls']}; "
          f"the card's census took {r['seconds']:.2f} s ({card})")


def _census_exchanges(device, card):
    """6q (c): the EP block at EP's shape on a 2 x 4 mesh of cuda:0 entries
    and the pipeline at PIPE's, each once under a census: the exchanges
    against the analytic count and bytes."""
    import torch

    from repro_torch import configs
    from repro_torch.distributed import pipeline
    from repro_torch.launch import census
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import layers, moe

    cfg = configs.get_config("deepseek-moe-16b")
    p = layers.init_params(moe.moe_schema(cfg), SEED + 30, device, dtype=torch.float32)
    d, m = EP["mesh"]
    mesh = mesh_lib.make_dev_mesh(d, m, devices=[_entry(device)] * (d * m))
    b, s = EP["x"]
    x = torch.randn((b, s, cfg.d_model), generator=_gen(device, SEED + 31), device=device)
    with torch.no_grad(), census.StepCensus() as c:
        moe.moe_block_ep(x, p, cfg, mesh)
    got = census.collective_census(c)
    _, n_split, _, cap = moe.ep_layout(b * s, cfg, mesh)
    n_pos, block = d * m, (cfg.n_experts // m) * cap * cfg.d_model * x.element_size()
    moves = 2 * n_pos * (m - 1)  # dispatch and return, from each model-row peer
    want = {"all-to-all": {"count": moves, "bytes": moves * block}, "total_bytes": moves * block}
    check(got == want, f"census (c): EP exchanges {got} against {want}")
    print(f"  (c) moe_block_ep (deepseek-moe-16b, x {tuple(x.shape)} f32) on a {d} x {m} mesh of "
          f"cuda:0 entries, {n_split} token shards, capacity {cap}: all-to-all {moves} moves, "
          f"{moves * block} bytes = 2 x {n_pos} positions x {m - 1} peers x ({cfg.n_experts // m}"
          f" experts x {cap} x {cfg.d_model} x 4 B), as counted ({card})")
    del p, x
    n, mb, rows = PIPE["stages"], PIPE["microbatches"], PIPE["batch"]
    stage = mesh_lib.make_mesh((n,), ("stage",), devices=[_entry(device)] * n)
    res = {"ep": got, "pipeline": {}}
    for width in PIPE["widths"]:
        h = torch.randn((mb, rows, width), generator=_gen(device, SEED + 32), device=device)
        w = torch.randn((n, width, width), generator=_gen(device, SEED + 33),
                        device=device) / math.sqrt(width)
        with torch.no_grad(), census.StepCensus() as c:
            pipeline.pipeline_forward(h, {"w": w}, lambda a, q: torch.tanh(a @ q["w"]), stage)
        got = census.collective_census(c)
        hops = (n + mb - 1) * (n - 1)
        want = {"collective-permute": {"count": hops, "bytes": hops * rows * width * 4},
                "total_bytes": hops * rows * width * 4}
        check(got == want, f"census (c): pipeline hand-offs {got} against {want}")
        res["pipeline"][width] = got
        print(f"  (c) pipeline_forward, {n} stages, {mb} microbatches of {rows} x {width}: "
              f"collective-permute {hops} hand-offs, {hops * rows * width * 4} bytes "
              f"(= ({n} + {mb} - 1) ticks x {n - 1} x {rows * width * 4} B) ({card})")
    return res


def phase_census(sweep, device="cuda"):
    """6q: the dry-run census (see the module docstring and ``CENSUS``);
    ``sweep`` is ``_start_census_sweep()``'s, started before 6p."""
    import torch

    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib

    t_phase = time.perf_counter()
    card = _card()
    total, procs = sweep
    torch.cuda.empty_cache()
    res = {"allocated_before": torch.cuda.memory_allocated()}
    print(f"census (6q: the dry-run census on meta against the card; exchanges; the sweep) on "
          f"{card}: {res['allocated_before']} bytes allocated before it")
    cfg = configs.get_config(TRAIN["arch"])
    n_params = layers.count_params(model_lib.build_schema(cfg))
    with _ShapeLog() as log:
        # (a) 6l (b)'s training step.
        shape = ShapeConfig("train_6l", TRAIN["seq"], TRAIN["batch"], "train")
        ops.reset_launch_counts()
        r = dryrun.card_run(cfg, shape, TrainConfig(), False, device=device, seed=SEED)
        r["launches"] = {k: v for k, v in ops.launch_counts.items() if v}
        tokens = TRAIN["batch"] * TRAIN["seq"]
        r["six_n_tokens"] = 6 * n_params * tokens
        r["flops_over_6nt"] = r["flops_meta"] / r["six_n_tokens"]
        print(f"  (a) train_step ({TRAIN['arch']} full, {n_params} parameters, f32 master, remat, "
              f"B={TRAIN['batch']}, S={TRAIN['seq']}) on a one-entry mesh: census FLOPs "
              f"{r['flops_meta']} = {r['flops_over_6nt']:.4f} x 6 N tokens ({r['six_n_tokens']}); "
              f"bytes accessed {r['bytes_meta']}; launches {r['launches']}")
        _census_card_checks("(a)", r, card)
        check(all(r["launches"].get(k, 0) > 0 for k in TRAIN_KERNELS),
              f"census (a): the step launched {r['launches']}")
        res["train"] = r
        # (b) 6k's serve tick, bf16 weights.
        shape = ShapeConfig("serve_6k", BACKBONE["max_len"], BACKBONE["batch"], "decode")
        ops.reset_launch_counts()
        r = dryrun.card_run(cfg, shape, TrainConfig(), True, device=device, seed=SEED)
        r["launches"] = {k: v for k, v in ops.launch_counts.items() if v}
        r["two_n_tokens"] = 2 * n_params * BACKBONE["batch"]
        r["flops_over_2nt"] = r["flops_meta"] / r["two_n_tokens"]
        print(f"  (b) serve_step ({TRAIN['arch']} full, bf16 weights, B={BACKBONE['batch']}, "
              f"{BACKBONE['max_len']} slots) on a one-entry mesh: census FLOPs {r['flops_meta']} "
              f"= {r['flops_over_2nt']:.4f} x 2 N tokens; bytes accessed {r['bytes_meta']}; "
              f"launches {r['launches']}")
        _census_card_checks("(b)", r, card)
        check(all(r["launches"].get(k, 0) > 0 for k in ("xorshift_projection", "plan_rows")),
              f"census (b): the tick launched {r['launches']}")
        res["serve"] = r
        torch.cuda.empty_cache()
        # (c) the exchanges.
        res["exchanges"] = _census_exchanges(device, card)
    missing = log.missing()
    check(not missing, f"census: shapes phases 2-4 did not hold: {missing}")
    # (d) the sweep, from its processes.
    t_wait = time.perf_counter()
    recs, seconds = [], {}
    for arch, (proc, out, err) in procs.items():
        try:
            proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise AssertionError(f"census (d): {arch}'s cells did not end within 600 s")
        out.seek(0)
        err.seek(0)
        lines = [json.loads(x) for x in out.read().splitlines() if x.strip()]
        tail = err.read()[-2000:]
        out.close()
        err.close()
        check(proc.returncode == 0 and lines,
              f"census (d): {arch}'s process exited {proc.returncode}: {tail}")
        recs += lines[:-1]
        seconds[arch] = lines[-1]["sweep_seconds"]
    waited = time.perf_counter() - t_wait
    errors = [r for r in recs if r["status"] == "error"]
    check(not errors, f"census (d): cells in error: {errors}")
    check(len(recs) == len(CENSUS["families"]) * 4, f"census (d): {len(recs)} cells")
    print(f"  (d) run_cell on the 16 x 16 meta mesh, one arch per family, every LM shape "
          f"(device memory {total} bytes, the card's): {len(recs)} cells, one process a "
          f"family, the slowest {max(seconds.values()):.1f} s ("
          + ", ".join(f"{a} {v:.1f}" for a, v in seconds.items())
          + f"); 6q waited {waited:.1f} s for them after (c)")
    for r in recs:
        if r["status"] != "ok":
            print(f"    {r['arch']:<18} {r['shape']:<12} skipped: {r['reason']}")
            continue
        print(f"    {r['arch']:<18} {r['shape']:<12} ok   peak {r['peak_bytes']:>16} of {total} "
              f"a device, fits {str(r['fits']):<5} flops_total {r['flops_total']:.6e} "
              f"bytes_total {r['bytes_total']:.6e} census {r['census_s']} s")
    res["sweep"] = {"cells": recs, "seconds": seconds, "waited": waited}
    res["shapes"] = {k: sorted(v) for k, v in log.shapes.items() if v}
    res["seconds"] = time.perf_counter() - t_phase
    print(f"  kernel shapes on 6q's card runs, each held in phases 2-4: {res['shapes']}")
    print(f"  phase 6q took {res['seconds']:.1f} s ({card})")
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
    """The whole RLS update (``ops.kernel_cost``): P in and out, beta in and
    out, H and Y in; 2 S N^2 (2k + m) operations (PHt, the downdate, P' W)
    at the f32 rate."""
    from repro_torch.kernels import ops

    return _bound(*ops.kernel_cost("oselm_rls_update_fleet", (s, n, k, m)))


def _projection_bound(b, n_in, n):
    """The projection (``ops.kernel_cost``: x in, H out, 2 b n_in N
    operations) as the kernel does it: three TF32 products on the tensor
    cores, the work at the precision the kernel must deliver, and the
    integer work of hashing alpha once (HASH_OPS_PER_ALPHA a value, over
    all SMs at the int32 rate), which bounds it at few rows.  The two run
    on separate units: the larger of the two and the bytes' time."""
    from repro_torch.kernels import ops

    flops, nbytes = ops.kernel_cost("xorshift_projection", (b, n_in, n))
    t_ops = max(3 * flops / PEAK_TF32_FLOPS, HASH_OPS_PER_ALPHA * n_in * n / PEAK_INT32_OPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def _projection_times(shape, device="cuda"):
    """Phase 7's projection at (b, n_in, N): the kernel by its plan, its
    plain version, cuBLAS f32 with alpha materialized (the yardstick; the
    port never calls it), the bound, the plan's grid and its workspace."""
    import torch

    from repro_torch.core import xorshift
    from repro_torch.kernels import ref, xorshift_proj

    b, n_in, n = shape
    x = _cycling_x(device, b, n_in)
    alpha = xorshift.alpha_hash(0x2D2A, n_in, n, device=device)
    c = float(1.0 / n_in ** 0.5)
    plan = xorshift_proj.projection_plan(b, n_in, n)
    return dict(
        shape=list(shape),
        ms=_device_ms(lambda: xorshift_proj.xorshift_projection(x(), 0x2D2A, n)),
        plain_ms=_device_ms(lambda: ref.xorshift_projection_ref(x(), 0x2D2A, n), reps=PLAIN_REPS),
        library_ms=_device_ms(lambda: torch.sigmoid(torch.matmul(x(), alpha) * c)),
        grid=list(plan.grid), workspace_bytes=plan.workspace_bytes,
        **dict(zip(("bound_ms", "bound_by"), _projection_bound(b, n_in, n))),
    )


def _rls_times(shape, device="cuda", seed=SEED):
    """Phase 7's RLS update of S streams through the dispatch at (S, N, k,
    m): the kernel, its plain version, the torch composite, the bound."""
    from repro_torch.kernels import ops, oselm_update, ref

    s, n, k, m = shape
    P, beta, H, Y = _rls_inputs(s, n, k, m, device, seed)
    out = dict(shape=list(shape), plan=list(oselm_update.single_pass_plan(n, k, m)),
               clusters=oselm_update.launch_clusters(s, n, k, m),
               **dict(zip(("bound_ms", "bound_by"), _rls_bound(s, n, k, m))))
    kernel = lambda: ops.oselm_rls_update_fleet(P, beta, H, Y)  # noqa: E731
    if n < 256:
        return dict(out, ms=_device_ms(kernel),
                    plain_ms=_device_ms(lambda: ref.rls_update_ref(P, beta, H, Y),
                                        reps=PLAIN_REPS),
                    library_ms=_device_ms(lambda: _rls_composite(P, beta, H, Y),
                                          reps=PLAIN_REPS))
    # At N=256 the plain and library versions' batched lu_solve makes the
    # host wait: all three by single calls, as the N=256 fleet row.
    return dict(out, ms=_call_ms(kernel), batched_ms=_device_ms(kernel),
                plain_ms=_call_ms(lambda: ref.rls_update_ref(P, beta, H, Y)),
                library_ms=_call_ms(lambda: _rls_composite(P, beta, H, Y)),
                timed="all three by CUDA events around single calls (_call_ms: a call's "
                      "host time in the wrapper included); batched_ms is the kernel by "
                      "_device_ms")


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

    from repro_torch.kernels import ops, oselm_update, plan_rows, ref

    rows = []
    rows.append(dict(name="xorshift_projection", **_projection_times(K1_SHAPES[0], device),
                     library="sigmoid(matmul(x, alpha) * c), cuBLAS f32"))
    # The same at N=256 (Tables 2-3's width), on the same fleet of x.
    rows[-1]["n256"] = _projection_times(K1_N256, device)

    s, n, k, m = K2_SHAPES[0]
    P, beta, H, Y = _rls_inputs(s, n, k, m, device, SEED)
    rows.append(dict(
        name="oselm_rls_update_fleet",
        plan=list(oselm_update.single_pass_plan(n, k, m)),
        clusters=oselm_update.launch_clusters(s, n, k, m),
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
        clusters=oselm_update.launch_clusters(s, n, k, m),
        ms=_call_ms(lambda: oselm_update.rls_single(P, beta, H, Y)),
        plain_ms=_call_ms(lambda: ref.rls_update_ref(P, beta, H, Y)),
        library_ms=_call_ms(lambda: _rls_composite(P, beta, H, Y)),
        batched_ms=_device_ms(lambda: oselm_update.rls_single(P, beta, H, Y)),
        timed="all three by CUDA events around single calls (_call_ms; the plain and "
              "library versions' batched lu_solve makes the host wait at N=256); "
              "batched_ms is the kernel by _device_ms",
        **dict(zip(("bound_ms", "bound_by"), _rls_bound(s, n, k, m))),
    )
    del P, beta, H, Y

    _, n, k, m = K3_SHAPES[0]
    P, beta, H, Y = (a[0] for a in _rls_inputs(1, n, k, m, device, SEED + 3))
    rows.append(dict(
        name="oselm_rls_update",
        plan=list(oselm_update.single_pass_plan(n, k, m)),
        clusters=oselm_update.launch_clusters(1, n, k, m),
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

            # The pass's whole call (``ops.kernel_cost``): h, beta, count and
            # the state leaves in, x too where the detector steps; the plan's
            # fields, prune and meter out, drift too where it steps.
            ops_, moved = ops.kernel_cost("plan_rows", tuple(shape), mode=mode,
                                          use_features=cfg.drift.use_features)
            out[mode] = dict(
                shape=list(shape), ms=_device_ms(kernel),
                plain_ms=_device_ms(plain, reps=PLAIN_REPS), bytes=moved,
                **dict(zip(("bound_ms", "bound_by"), _bound(flops=ops_, nbytes=moved))))
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
        **dict(zip(("bound_ms", "bound_by"), _bound(*ops.kernel_cost("readout", (s, n, m))))),
    ))
    rows.append(dict(
        name="row_abs_mean",
        ms=_device_ms(lambda: plan_rows.row_abs_mean(x())),
        plain_ms=_device_ms(lambda: ref.row_abs_mean_ref(x())),
        library_ms=_device_ms(lambda: torch.mean(x().abs(), -1)),
        library="torch.mean(x.abs(), -1)",
        **dict(zip(("bound_ms", "bound_by"), _bound(*ops.kernel_cost("row_abs_mean",
                                                                      (s, n_in))))),
    ))
    del h, beta, x, args
    # The three path kernels at the dense backbone's serving shape (phase
    # 6k: 256 streams of qwen3-4b's d_model), and the plan's pass at the
    # widest dense d_model, whose x rows are read from device memory.
    by_name = {r["name"]: r for r in rows}
    by_name["xorshift_projection"]["backbone"] = _projection_times(K1_BACKBONE, device)
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
    # The two kernels of the training path (phase 6l) at its full-width
    # shape: the projection of B = 32 pooled rows of d_model 2,560, and the
    # one-head RLS update of those 32 rows.
    by_name["xorshift_projection"]["train"] = _projection_times(K1_TRAIN, device)
    s, n, k, m = K3_TRAIN
    P, beta, H, Y = (a[0] for a in _rls_inputs(s, n, k, m, device, SEED + 13))
    by_name["oselm_rls_update"]["train"] = dict(
        shape=list(K3_TRAIN), plan=list(oselm_update.single_pass_plan(n, k, m)),
        ms=_device_ms(lambda: ops.oselm_rls_update(P, beta, H, Y)),
        plain_ms=_device_ms(lambda: ref.rls_update_ref(P[None], beta[None], H[None], Y[None]),
                            reps=PLAIN_REPS),
        library_ms=_device_ms(lambda: _rls_composite(P[None], beta[None], H[None], Y[None]),
                              reps=PLAIN_REPS),
        **dict(zip(("bound_ms", "bound_by"), _rls_bound(s, n, k, m))),
    )
    del P, beta, H, Y
    # The projection at the other training paths' shapes (6o (c), 6l (e)-(f)):
    # 32 pooled rows of whisper-small's, mamba2-780m's and recurrentgemma-9b's
    # d_model.
    for key, shape in K1_FAMILY_TRAIN.items():
        by_name["xorshift_projection"][key] = _projection_times(shape, device)
    # The one-head RLS update at 6p's training shapes (k = 32 and 8 rows).
    for key, (s, n, k, m) in K3_FAMILY_TRAIN.items():
        P, beta, H, Y = (a[0] for a in _rls_inputs(s, n, k, m, device, SEED + 18 + k))
        by_name["oselm_rls_update"][key] = dict(
            shape=[s, n, k, m], plan=list(oselm_update.single_pass_plan(n, k, m)),
            ms=_device_ms(lambda: ops.oselm_rls_update(P, beta, H, Y)),
            plain_ms=_device_ms(lambda: ref.rls_update_ref(P[None], beta[None], H[None],
                                                           Y[None]), reps=PLAIN_REPS),
            library_ms=_device_ms(lambda: _rls_composite(P[None], beta[None], H[None], Y[None]),
                                  reps=PLAIN_REPS),
            **dict(zip(("bound_ms", "bound_by"), _rls_bound(s, n, k, m))),
        )
        del P, beta, H, Y
    # The MoE archs' serving shapes (phase 6m): 256 streams of
    # deepseek-moe-16b's d_model 2,048 and of deepseek-v2-236b's 5,120.
    for key, shape, plan, seed in (("moe", K1_MOE, PLAN_MOE, SEED + 14),
                                   ("mla", K1_MLA, PLAN_MLA, SEED + 15),
                                   ("ssm", K1_SSM, PLAN_SSM, SEED + 16),
                                   ("hybrid", K1_HYBRID, PLAN_HYBRID, SEED + 17)):
        by_name["xorshift_projection"][key] = _projection_times(shape, device)
        served, _, _ = pass_times(plan, ("serve",), seed)
        by_name["plan_rows"][key] = dict(served["serve"], library_ms=None)
    served, _, _ = pass_times(PLAN_BACKBONE, ("serve",), SEED + 11)
    wide, _, _ = pass_times(PLAN_WIDE, ("serve",), SEED + 12)
    by_name["plan_rows"]["backbone"] = dict(served["serve"], library_ms=None)
    by_name["plan_rows"]["wide"] = dict(wide["serve"], library_ms=None)
    # The paper's S = 1 trials (5b): one stream's projection and RLS update
    # (the fleet entry, k = 1) at N = 128 and 256.
    for key, shape in PAPER_K1.items():
        by_name["xorshift_projection"][key] = _projection_times(shape, device)
    for key, shape in PAPER_K2.items():
        by_name["oselm_rls_update_fleet"][key] = _rls_times(shape, device, SEED + 19)
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
    for name in ("xorshift_projection", "oselm_rls_update_fleet", "oselm_rls_update",
                 "plan_rows"):
        for key in ("backbone", "wide", "train", "moe", "mla", "ssm", "hybrid",
                    *K1_FAMILY_TRAIN, *PAPER_K1):
            w = by_name[name].get(key)
            if w is None:
                continue
            lib = "none" if w["library_ms"] is None else f"{w['library_ms']:.4f} ms"
            where = {"backbone": "serve", "wide": "widest", "train": "training",
                     "moe": "deepseek-moe-16b serve", "mla": "deepseek-v2-236b serve",
                     "ssm": "mamba2-780m serve", "hybrid": "recurrentgemma-9b serve",
                     "encdec_train": "whisper-small training",
                     "ssm_train": "mamba2-780m training",
                     "hybrid_train": "recurrentgemma-9b training",
                     "moe_train": "deepseek-moe-16b training",
                     "mla_train": "deepseek-v2-236b training",
                     "paper_trial": "paper trial", "paper_trial_n256": "paper trial N=256"}[key]
            plan = (f", grid {w['grid']}, workspace {w['workspace_bytes']} B" if "grid" in w
                    else f", plan {w['plan']}" if "plan" in w else "")
            if "clusters" in w:
                plan += f", {w['clusters']} cluster(s)"
            if "batched_ms" in w:
                plan += f", batched (_device_ms) {w['batched_ms']:.4f} ms"
            print(f"time {name} at the backbone's {where} "
                  f"shape {w['shape']}: kernel {w['ms']:.4f} ms, plain {w['plain_ms']:.4f} ms, "
                  f"library {lib}, bound {w['bound_ms']:.4f} ms ({w['bound_by']}, "
                  f"{100 * w['bound_ms'] / w['ms']:.1f} % of it reached){plan}")
    for r in rows[:2]:
        w = r["n256"]
        events = f" (batched {w['batched_ms']:.4f} ms)" if "batched_ms" in w else ""
        if "clusters" in w:
            events += f", plan {w['plan']} on {w['clusters']} clusters"
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
    # One drift trial of the paper's tables (1,008 one-stream ticks at
    # N=128, theta=1) behind a warm-up trial; null without the harness.
    # Where run_fleet has a chunk runner the timed trial captures its own
    # graph (its seed makes its cfg its own), and that capture is timed in.
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
    ap.add_argument("--census-sweep", nargs=2, metavar=("ARCH", "DEVICE_BYTES"),
                    help=argparse.SUPPRESS)  # 6q (d)'s processes
    args = ap.parse_args(argv)
    if args.census_sweep is not None:
        return _census_sweep_child(args.census_sweep[0], int(args.census_sweep[1]))
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
    chunked = phase_chunk_runner()
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
    trained = phase_train()
    moe = phase_moe()
    recurrent = phase_recurrent()
    encdec_res = phase_encdec()
    sweep = _start_census_sweep()  # 6q (d), host-bound, beside 6p, 6s and 6q (a)-(c)
    moe_train = phase_moe_train()
    partitioned = phase_partitioned()
    partitioned_moe = phase_partitioned_moe()
    phase_census(sweep)
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
            # Phase 6's two run_fleet calls: eager launches (each graph's
            # one-tick warm-up) + graph replays, and the replays alone.
            "launches": fleet["launches"][name],
            "fleet_replays": fleet["replays"][name],
            # The chunk runner (phase 6r): replays of its chunk graphs.
            "chunk_replays": chunked["replays"][name],
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
            # The dense backbone's training path (phase 6l (b)): eager
            # launches (the training step captures no graph).
            "train_launches": trained["launches"].get(name, 0),
            "train_replays": trained["replays"].get(name, 0),
            # The other training paths, each counted from 0 around its
            # launch.train.train run: whisper-small (phase 6o (c)),
            # mamba2-780m (6l (e)) and recurrentgemma-9b at 6 layers (6l (f)).
            "encdec_train_launches": encdec_res["train"]["launches"].get(name, 0),
            "encdec_train_replays": encdec_res["train"]["replays"].get(name, 0),
            "ssm_train_launches": trained["ssm"]["launches"].get(name, 0),
            "ssm_train_replays": trained["ssm"]["replays"].get(name, 0),
            "hybrid_train_launches": trained["hybrid"]["launches"].get(name, 0),
            "hybrid_train_replays": trained["hybrid"]["replays"].get(name, 0),
            # The MoE and MLA stacks' training paths (phase 6p (b) and (d)),
            # each counted from 0 around its launch.train.train run.
            "moe_train_launches": moe_train["deepseek-moe-16b"]["launches"].get(name, 0),
            "moe_train_replays": moe_train["deepseek-moe-16b"]["replays"].get(name, 0),
            "mla_train_launches": moe_train["deepseek-v2-236b"]["launches"].get(name, 0),
            "mla_train_replays": moe_train["deepseek-v2-236b"]["replays"].get(name, 0),
            # The dense training step over partitioned leaves (phase 6s):
            # eager launches and replays over its f32 and bf16 steps.
            "partitioned_train_launches": partitioned["launches"].get(name, 0),
            "partitioned_train_replays": partitioned["replays"].get(name, 0),
            # The DeepSeek stacks' training step over partitioned leaves
            # (phase 6t): launches + replays over its compared steps
            # (deepseek-moe-16b dense and ep, deepseek-v2-236b).
            "partitioned_moe_train_launches": partitioned_moe["launches"].get(name, 0),
            # The MoE archs' serving path (phase 6m, (a)-(f)): eager launches
            # and graph replays in this process, and, apart, in its two
            # workers (summed from their own scrapes).
            "moe_launches": moe["launches"].get(name, 0),
            "moe_replays": moe["replays"].get(name, 0),
            "moe_worker_launches": moe["worker_launches"].get(name, 0),
            "moe_worker_replays": moe["worker_replays"].get(name, 0),
            # The SSD and hybrid archs' serving path (phase 6n): eager
            # launches and graph replays in this process on mamba2-780m's
            # path ((a)-(f)) and recurrentgemma-9b's ((a)-(e)), and, apart,
            # in the two workers of (h) (summed from their own scrapes).
            "ssm_launches": recurrent["ssm"]["launches"].get(name, 0),
            "ssm_replays": recurrent["ssm"]["replays"].get(name, 0),
            "hybrid_launches": recurrent["hybrid"]["launches"].get(name, 0),
            "hybrid_replays": recurrent["hybrid"]["replays"].get(name, 0),
            "hybrid_worker_launches": recurrent["worker"]["worker_launches"].get(name, 0),
            "hybrid_worker_replays": recurrent["worker"]["worker_replays"].get(name, 0),
            # The paper's tables (phase 5b): eager launches, both widths.
            "paper_launches": paper["launches"].get(name, 0),
            "paper_replays": paper["replays"].get(name, 0),
            "paper_max_abs_err": paper["errs"].get(name),
            "max_abs_err": info["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": t["library"],
            # The single pass's plan and the persistent clusters its launch
            # ran at the timed shape (as many as the card holds at once).
            "plan": t.get("plan"),
            "clusters": t.get("clusters"),
            # Phase 7 at N=256 (the paper's Tables 2-3 width), where timed.
            "n256": t.get("n256"),
            # The plan's pass in train_phase (no x read), where timed.
            "train_phase": t.get("train_phase"),
            # Phase 7 at the backbone's serving shape (6k), and the plan's
            # pass at the widest dense d_model, where timed.
            "backbone": t.get("backbone"),
            "wide": t.get("wide"),
            # Phase 7 at 6l's training shape, where timed.
            "train": t.get("train"),
            # Phase 7 at 6m's serving shapes (n_in 2,048 and 5,120), where timed.
            "moe": t.get("moe"),
            "mla": t.get("mla"),
            # Phase 7 at 6n's serving shapes (n_in 1,536 and 4,096), where timed.
            "ssm": t.get("ssm"),
            "hybrid": t.get("hybrid"),
            # Phase 7 at 6o (c)'s, 6l (e)-(f)'s and 6p (b), (d)'s training
            # shapes (n_in 768, 1,536, 4,096, 2,048 and 5,120; the RLS update
            # at k = 32 and 8), where timed.
            **{key: t.get(key) for key in K1_FAMILY_TRAIN},
            # Phase 7 at the paper trials' S = 1 shapes (N = 128 and 256),
            # where timed.
            **{key: t.get(key) for key in PAPER_K1},
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
