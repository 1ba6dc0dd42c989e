"""Where the single-pass RLS kernel's time goes on the card (kernel 3,
``oselm_rls_update``, at S = 1 and N = 128; kernel 2, ``oselm_rls_update_fleet``,
at N = 256, k = 1: the fleet's S = 16,384 and the paper trial's S = 1).

For each shape (S, N, k, m) it reports:

* the launch: its plan (blocks per stream, stages), the kernel body it runs
  (``rank1_stream``, ``rank1_cluster`` or the general body), threads and
  shared memory, the clusters the launch runs (``launch_clusters``: as
  many as the card holds at once, from ``cudaOccupancyMaxActiveClusters``)
  beside SMs / blocks per stream, and the SMs it leaves idle;
* device times (CUDA events around back-to-back calls queued behind a
  sleep, so the host's launch cost is hidden), and the host's time to
  enqueue one call: the kernel and, at S = 1 and N = 128, its plain version
  (``ref.rls_update_ref``), the two-stage route as a whole (torch's
  ``small_operands``, then the fused pass ``rls_fleet_kernel``) and that
  pass alone, and a one-element ``add_`` as the floor of any launch;
* where the single pass spends its time: a copy of the source built with
  ``-DRLS_PHASE_CLOCKS`` notes the SM clock at each phase boundary of one
  stream (the ``--stream``-th that cluster 0 takes; the fleet's default is
  a stream in the middle of its walk, where the ring is full) in every
  block of the cluster; for each block rank the median cycles of each
  phase over the launches, and the global timer's nanoseconds for the
  stream, convert them to microseconds.  The marked build's outputs must
  equal the kernel's bit for bit, and both the plain version's within the
  kernels' tolerances (P 2e-5, β 2e-4).

``--clusters C`` launches C persistent clusters instead of as many as fit
(the grid of a checkout that sized it by SMs was SMs / blocks per stream).

Run on a machine with a card and ``nvcc``:

    PYTHONPATH=src python3 -m repro_torch.benchmarks.rls_breakdown [--shapes all|n128|n256]
        [--stream I] [--clusters C] [--out FILE]

It prints a few lines per shape and writes the whole as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

M = 6
SHAPES = {  # (S, N, k, m): the training path's one head, then the fleet's N = 256
    "n128": [(1, 128, k, M) for k in (1, 8, 16, 32, 64)],
    "n256": [(16384, 256, 1, M), (1, 256, 1, M)],
}
FLEET_MARK_STREAM = 100  # of cluster 0's ~500 streams at S = 16,384: the ring is full there
START = ("start: barriers, copies issued (stream 0 only)", 0, 1)
WAIT = ("wait for the stage", 1, 2)
PHASES = {  # (name, first mark, last mark) of the marks in csrc/oselm_update.cu, by body
    "general": (
        ("1. PHt = P H^T", 2, 3),
        ("2. S share, E = Y - H beta", 3, 4),
        ("2. W = H^T E", 4, 5),
        ("3. S, right-hand side (cluster barrier)", 5, 6),
        ("4. Gauss-Jordan, G (gathered on a cluster)", 6, 7),
        ("5. P' = P - PHt G, beta' = beta + P' W; stage freed", 7, 8),
    ),
    "rank1_stream": (("the rank-1 path (rank1_stream)", 2, 8),),
    "rank1_cluster": (
        ("1. PHt rows, share of H beta, slots written", 2, 3),
        ("cluster barrier", 3, 4),
        ("2. refill issued; S, E, G from the slots", 4, 5),
        ("3. P' = P - PHt G, beta' = beta + (P'h) E", 5, 8),
    ),
}
N_MARKS = 9
MARK_RANKS = 4
SLEEP_CYCLES = 200_000_000  # about 0.1 s of device time ahead of each timed batch
MARKED_RUNS = 41
PLAIN_REPS = 4


def _marked_library() -> ctypes.CDLL:
    """The kernel source built with its phase marks, beside the kernels' own
    build (``build/rls_phase_clocks/<hash>``)."""
    from repro_torch.kernels import build

    src = build.CSRC / "oselm_update.cu"
    flags = (*build.NVCC_FLAGS, "-DRLS_PHASE_CLOCKS")
    key = hashlib.sha256(" ".join(flags).encode() + src.read_bytes()).hexdigest()[:16]
    out = build.BUILD_ROOT.parent / "rls_phase_clocks" / key
    lib = out / "liboselm_update_marked.so"
    if not lib.is_file():
        out.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([build.nvcc(), *flags, "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc of the marked build failed:\n{proc.stdout}{proc.stderr}")
    cdll = ctypes.CDLL(str(lib))
    cdll.oselm_rls_single_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    cdll.oselm_rls_single_launch.restype = ctypes.c_int
    cdll.oselm_rls_phase_marks.argtypes = [ctypes.c_void_p]
    cdll.oselm_rls_phase_marks.restype = ctypes.c_int
    cdll.oselm_rls_phase_reset.restype = ctypes.c_int
    cdll.oselm_rls_phase_select.argtypes = [ctypes.c_int]
    cdll.oselm_rls_phase_select.restype = ctypes.c_int
    return cdll


def _inputs(s: int, n: int, k: int, m: int, seed: int):
    """An SPD P, beta, H and one-hot Y of s streams, as the engine gives them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(s, n, n, generator=g, device="cuda") / n ** 0.5
    P = torch.bmm(a, a.transpose(1, 2)) + 0.1 * torch.eye(n, device="cuda")
    del a
    beta = 0.1 * torch.randn(s, n, m, generator=g, device="cuda")
    H = torch.sigmoid(torch.randn(s, k, n, generator=g, device="cuda"))
    Y = torch.nn.functional.one_hot(
        torch.randint(0, m, (s, k), generator=g, device="cuda"), m).to(torch.float32)
    return P, beta, H, Y


def body(n: int, k: int, m: int, c: int) -> str:
    """The kernel body a (N, k, m) launch on clusters of c blocks runs."""
    from repro_torch.kernels import oselm_update

    if k == 1 and c == 1 and n <= 128 and m <= 8:
        return "rank1_stream"
    return "rank1_cluster" if oselm_update.rank1_cluster(n, k, m, c) else "general"


def _device_ms(fn, reps: int = 200, rounds: int = 5) -> tuple[float, float]:
    """(device ms of one call, host ms to enqueue one): events around up to
    ``reps`` calls queued behind a sleep of the card, as many as the host
    enqueues in half the sleep, the median of ``rounds``.  Raises if the
    host took longer than the sleep (the events would time the host)."""
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_call_ms = 1e3 * (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    b.record()
    b.synchronize()
    sleep_ms = a.elapsed_time(b)
    n = max(1, min(reps, int(0.5 * sleep_ms / max(host_call_ms, 1e-3))))
    times, hosts = [], []
    for _ in range(rounds):
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        b.record()
        b.synchronize()
        if host_ms >= sleep_ms:
            raise RuntimeError(f"the host took {host_ms:.1f} ms to enqueue {n} calls, "
                               f"longer than the {sleep_ms:.1f} ms sleep")
        times.append(a.elapsed_time(b) / n)
        hosts.append(host_ms / n)
    return statistics.median(times), statistics.median(hosts)


def _marks(lib, P, beta, H, Y, plan, stream_i, clusters) -> tuple[list[list[int]], tuple]:
    """Each marked launch's (cycles, ns) at every (block rank, mark), and
    the last launch's outputs."""
    s, n, k, m = P.shape[0], P.shape[1], H.shape[1], beta.shape[2]
    new_p, new_beta = torch.empty_like(P), torch.empty_like(beta)
    buf = (ctypes.c_ulonglong * (MARK_RANKS * 2 * N_MARKS))()
    runs = []
    stream = torch.cuda.current_stream().cuda_stream
    if lib.oselm_rls_phase_select(stream_i) != 0:
        raise RuntimeError("choosing the marked stream failed")
    for _ in range(MARKED_RUNS):
        if lib.oselm_rls_phase_reset() != 0:
            raise RuntimeError("resetting the marks failed")
        rc = lib.oselm_rls_single_launch(P.data_ptr(), beta.data_ptr(), H.data_ptr(),
                                         Y.data_ptr(), new_p.data_ptr(), new_beta.data_ptr(),
                                         s, n, k, m, *plan, clusters or 0, stream)
        if rc != 0:
            raise RuntimeError(f"the marked launch failed: {rc}")
        torch.cuda.synchronize()
        if lib.oselm_rls_phase_marks(ctypes.cast(buf, ctypes.c_void_p)) != 0:
            raise RuntimeError("reading the marks failed")
        runs.append(list(buf))
    return runs[1:], (new_p, new_beta)  # the first launch loads the module


def _rank_phases(runs, rank: int, names) -> dict:
    """Median cycles and microseconds of each phase of one block rank."""
    base = rank * 2 * N_MARKS
    cycles = [[r[base + 2 * i] for i in range(N_MARKS)] for r in runs]
    nanos = [[r[base + 2 * i + 1] for i in range(N_MARKS)] for r in runs]
    total_cycles = statistics.median(c[8] - c[1] for c in cycles)
    total_ns = statistics.median(t[8] - t[1] for t in nanos)
    ns_per_cycle = total_ns / total_cycles if total_cycles else float("nan")
    phases = []
    for name, lo, hi in names:
        cyc = statistics.median(c[hi] - c[lo] for c in cycles)
        phases.append(dict(phase=name, cycles=cyc, us=1e-3 * cyc * ns_per_cycle,
                           share=cyc / total_cycles if total_cycles else float("nan")))
    return dict(rank=rank, stream_us=1e-3 * total_ns, stream_cycles=total_cycles,
                ns_per_cycle=ns_per_cycle, phases=phases)


def measure(shape, lib, seed: int, stream_i: int | None = None,
            clusters: int | None = None) -> dict:
    from repro_torch.benchmarks.kernel_routes import _call_ms
    from repro_torch.kernels import ops, oselm_update, ref

    s, n, k, m = shape
    P, beta, H, Y = _inputs(s, n, k, m, seed)
    plan = oselm_update.single_pass_plan(n, k, m)
    c, ns = plan
    kind = body(n, k, m, c)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kw = {} if clusters is None else dict(clusters=clusters)
    fitted = oselm_update.launch_clusters(s, n, k, m)
    used = oselm_update.launch_clusters(s, n, k, m, clusters=clusters)
    walk = -(-s // used)  # streams of cluster 0
    if stream_i is None:
        stream_i = min(FLEET_MARK_STREAM, walk - 1) if s > 1 else 0
    if not 0 <= stream_i < walk:
        raise ValueError(f"stream {stream_i} is not one of cluster 0's {walk}")

    want = oselm_update.rls_single(P, beta, H, Y, **kw)
    runs, got = _marks(lib, P, beta, H, Y, plan, stream_i, clusters)
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    del got
    p_ref, b_ref = ref.rls_update_ref(P, beta, H, Y)
    err_p = (want[0] - p_ref).abs().max().item()
    err_b = (want[1] - b_ref).abs().max().item()
    del p_ref, b_ref, want

    names = ((START,) if stream_i == 0 else ()) + (WAIT,) + PHASES[kind]
    ranks = [_rank_phases(runs, r, names) for r in range(min(c, MARK_RANKS))]

    out = dict(
        shape=list(shape), plan=list(plan), body=kind, marked_stream=stream_i,
        launch=dict(clusters=used, fitted_clusters=fitted, sms_over_blocks=sms // c,
                    cluster_blocks=c, stages=ns, blocks=used * c, threads=256,
                    smem_bytes=oselm_update.single_pass_smem_bytes(n, k, m, c, ns),
                    sms=sms, idle_sms=max(0, sms - used * c), streams_per_cluster=walk),
        max_abs_err_p=err_p, max_abs_err_beta=err_b,
        within_tolerance=err_p <= 2e-5 and err_b <= 2e-4,
    )
    kernel = lambda: oselm_update.rls_single(P, beta, H, Y, **kw)  # noqa: E731
    if n == 256:
        out["kernel_ms"], out["kernel_host_ms"] = _device_ms(kernel, reps=8 if s > 1 else 200)
        out["kernel_call_ms"] = _call_ms(kernel)
    else:
        x = torch.zeros(1, device="cuda")
        pht, g, w = oselm_update.small_operands(P, beta, H, Y)
        times = dict(
            kernel=lambda: ops.oselm_rls_update(P[0], beta[0], H[0], Y[0]),
            plain=lambda: ref.rls_update_ref(P, beta, H, Y),
            two_stage=lambda: oselm_update.rls_fleet(
                P, beta, *oselm_update.small_operands(P, beta, H, Y)),
            two_stage_pass=lambda: oselm_update.rls_fleet(P, beta, pht, g, w),
            launch_floor=lambda: x.add_(1.0),
        )
        for name, fn in times.items():
            # The plain version and the two-stage route launch tens of kernels a
            # call: a few calls keep the launch queue from filling.
            reps = PLAIN_REPS if name in ("plain", "two_stage") else 200
            out[f"{name}_ms"], out[f"{name}_host_ms"] = _device_ms(fn, reps=reps)
    del P, beta, H, Y
    return dict(out, marked_bit_for_bit=same, ranks=ranks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", choices=("all", *SHAPES), default="all")
    ap.add_argument("--stream", type=int, default=None,
                    help="the stream of cluster 0's walk to mark (default: 0 at S = 1, "
                         f"{FLEET_MARK_STREAM} in a fleet)")
    ap.add_argument("--clusters", type=int, default=None,
                    help="launch this many clusters instead of as many as fit")
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rls_breakdown: no CUDA device", file=sys.stderr)
        return 1
    lib = _marked_library()
    shapes = [sh for key, group in SHAPES.items() if args.shapes in ("all", key) for sh in group]
    rows = [measure(sh, lib, seed=100 + sh[2] + sh[1], stream_i=args.stream,
                    clusters=args.clusters) for sh in shapes]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    for r in rows:
        ln = r["launch"]
        times = ", ".join(f"{key[:-3]} {val:.4f}" for key, val in r.items()
                          if key.endswith("_ms") and not key.endswith("host_ms"))
        print(f"rls {tuple(r['shape'])} plan {tuple(r['plan'])} body {r['body']}: "
              f"{ln['clusters']} cluster(s) of {ln['cluster_blocks']} (fit {ln['fitted_clusters']}, "
              f"SMs / blocks {ln['sms_over_blocks']}), {ln['threads']} threads, "
              f"{ln['smem_bytes']} B smem, {ln['idle_sms']} of {ln['sms']} SMs idle, "
              f"{ln['streams_per_cluster']} streams a cluster; ms: {times}; "
              f"P err {r['max_abs_err_p']:.3e}, beta err {r['max_abs_err_beta']:.3e}; "
              f"marked stream {r['marked_stream']}, bit for bit {r['marked_bit_for_bit']}")
        for rk in r["ranks"]:
            print(f"  rank {rk['rank']}: stream {rk['stream_us']:.2f} us")
            for p in rk["phases"]:
                print(f"    {p['phase']:<52} {p['us']:8.2f} us  {100 * p['share']:5.1f} %")
    print(f"card: {card.strip()}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card.strip(), rows=rows), indent=1))
    return 0 if all(r["marked_bit_for_bit"] and r["within_tolerance"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
