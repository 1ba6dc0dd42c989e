"""Where the one-head RLS kernel's time goes on the card (kernel 3,
``oselm_rls_update``, the single pass of ``csrc/oselm_update.cu`` at S = 1).

For each rank k at N = 128, m = 6 (the training path's head; k is the
step's batch) it reports:

* the launch: blocks, threads and shared memory of the single pass (its
  plan: one block at k = 1, a cluster of four from k = 2 on), and the SMs
  it leaves idle (one stream takes one cluster);
* device times (CUDA events around back-to-back calls queued behind a
  sleep, so the host's launch cost is hidden), and the host's time to
  enqueue one call: the kernel, its plain
  version (``ref.rls_update_ref``), the two-stage route as a whole (torch's
  ``small_operands``, then the fused pass ``rls_fleet_kernel``) and that
  pass alone, and a one-element ``add_`` as the floor of any launch;
* where the single pass spends its time: a copy of the source built with
  ``-DRLS_PHASE_CLOCKS`` notes the SM clock at each phase boundary of the
  stream; the median cycles of each phase over the launches, and the
  global timer's nanoseconds for the whole, convert them to microseconds.
  The marked build's outputs must equal the kernel's bit for bit.

Run on a machine with a card and ``nvcc``:

    PYTHONPATH=src python3 -m repro_torch.benchmarks.rls_breakdown [--out FILE]

It prints one line per k and writes the whole as JSON to ``--out``.
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

N, M = 128, 6
RANKS = (1, 8, 16, 32, 64)
PHASES = (  # (name, first mark, last mark) of the marks in csrc/oselm_update.cu
    ("start: barriers, copies issued", 0, 1),
    ("wait for P, H, beta", 1, 2),
    ("1. PHt = P H^T", 2, 3),
    ("2. S share, E = Y - H beta", 3, 4),
    ("2. W = H^T E", 4, 5),
    ("3. S, right-hand side (own columns of PHt^T)", 5, 6),
    ("4. Gauss-Jordan (own columns of G), G gathered", 6, 7),
    ("5. P' = P - PHt G, beta' = beta + P' W", 7, 8),
)
RANK1_PHASE = ("the rank-1 path (rank1_stream)", 2, 8)  # k = 1 sets marks 0-2 and 8 only
N_MARKS = 9
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
    cdll.oselm_rls_single_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    cdll.oselm_rls_single_launch.restype = ctypes.c_int
    cdll.oselm_rls_phase_marks.argtypes = [ctypes.c_void_p]
    cdll.oselm_rls_phase_marks.restype = ctypes.c_int
    cdll.oselm_rls_phase_reset.restype = ctypes.c_int
    return cdll


def _inputs(k: int, seed: int):
    """An SPD P, beta, H and one-hot Y of one stream, as the engine gives them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(1, N, N, generator=g, device="cuda") / N ** 0.5
    P = torch.bmm(a, a.transpose(1, 2)) + 0.1 * torch.eye(N, device="cuda")
    beta = 0.1 * torch.randn(1, N, M, generator=g, device="cuda")
    H = torch.sigmoid(torch.randn(1, k, N, generator=g, device="cuda"))
    Y = torch.nn.functional.one_hot(
        torch.randint(0, M, (1, k), generator=g, device="cuda"), M).to(torch.float32)
    return P, beta, H, Y


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


def _marks(lib, P, beta, H, Y, plan) -> tuple[list[list[int]], tuple]:
    """Each marked launch's (cycles, ns) at every mark, and the last
    launch's outputs."""
    k = H.shape[1]
    new_p, new_beta = torch.empty_like(P), torch.empty_like(beta)
    buf = (ctypes.c_ulonglong * (2 * N_MARKS))()
    runs = []
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(MARKED_RUNS):
        if lib.oselm_rls_phase_reset() != 0:
            raise RuntimeError("resetting the marks failed")
        rc = lib.oselm_rls_single_launch(P.data_ptr(), beta.data_ptr(), H.data_ptr(),
                                         Y.data_ptr(), new_p.data_ptr(), new_beta.data_ptr(),
                                         1, N, k, M, *plan, stream)
        if rc != 0:
            raise RuntimeError(f"the marked launch failed: {rc}")
        torch.cuda.synchronize()
        if lib.oselm_rls_phase_marks(ctypes.cast(buf, ctypes.c_void_p)) != 0:
            raise RuntimeError("reading the marks failed")
        runs.append(list(buf))
    return runs[1:], (new_p, new_beta)  # the first launch loads the module


def measure(k: int, lib, seed: int) -> dict:
    from repro_torch.kernels import ops, oselm_update, ref

    P, beta, H, Y = _inputs(k, seed)
    plan = oselm_update.single_pass_plan(N, k, M)
    c, ns = plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clusters = max(1, min(1, sms // c))  # as the launch: never more clusters than streams
    blocks = clusters * c
    want = ops.oselm_rls_update(P[0], beta[0], H[0], Y[0])
    runs, got = _marks(lib, P, beta, H, Y, plan)
    same = all(torch.equal(g[0], w) for g, w in zip(got, want))

    cycles = [[r[2 * i] for i in range(N_MARKS)] for r in runs]
    nanos = [[r[2 * i + 1] for i in range(N_MARKS)] for r in runs]
    total_cycles = statistics.median(c_[8] - c_[0] for c_ in cycles)
    total_ns = statistics.median(n_[8] - n_[0] for n_ in nanos)
    ns_per_cycle = total_ns / total_cycles if total_cycles else float("nan")
    phases = []
    rank1 = any(c_[3] == 0 for c_ in cycles)
    for name, lo, hi in PHASES[:2] + (RANK1_PHASE,) if rank1 else PHASES:
        cyc = statistics.median(c_[hi] - c_[lo] for c_ in cycles)
        phases.append(dict(phase=name, cycles=cyc, us=1e-3 * cyc * ns_per_cycle,
                           share=cyc / total_cycles))

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
    out = dict(
        shape=[1, N, k, M],
        plan=list(plan),
        launch=dict(clusters=clusters, cluster_blocks=c, stages=ns, blocks=blocks,
                    threads=256, smem_bytes=oselm_update.single_pass_smem_bytes(N, k, M, c, ns),
                    sms=sms, idle_sms=sms - blocks),
    )
    for name, fn in times.items():
        # The plain version and the two-stage route launch tens of kernels a
        # call: a few calls keep the launch queue from filling.
        reps = PLAIN_REPS if name in ("plain", "two_stage") else 200
        out[f"{name}_ms"], out[f"{name}_host_ms"] = _device_ms(fn, reps=reps)
    return dict(
        out,
        marked_bit_for_bit=same,
        marked_total_us=1e-3 * total_ns,
        marked_total_cycles=total_cycles,
        phases=phases,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rls_breakdown: no CUDA device", file=sys.stderr)
        return 1
    lib = _marked_library()
    rows = [measure(k, lib, seed=100 + k) for k in RANKS]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    for r in rows:
        ln = r["launch"]
        print(f"rls (1, {N}, {r['shape'][2]}, {M}) plan {tuple(r['plan'])}: "
              f"{ln['blocks']} block(s) of {ln['threads']} "
              f"threads, {ln['smem_bytes']} B smem, {ln['idle_sms']} of {ln['sms']} SMs idle; "
              f"kernel {r['kernel_ms']:.4f} ms, plain {r['plain_ms']:.4f}, two-stage "
              f"{r['two_stage_ms']:.4f} (its pass {r['two_stage_pass_ms']:.4f}), launch floor "
              f"{r['launch_floor_ms']:.4f}; host ms a call: kernel {r['kernel_host_ms']:.4f}, "
              f"plain {r['plain_host_ms']:.4f}, two-stage {r['two_stage_host_ms']:.4f}; "
              f"marked build {r['marked_total_us']:.2f} us, bit for bit {r['marked_bit_for_bit']}")
        for p in r["phases"]:
            print(f"    {p['phase']:<42} {p['us']:8.2f} us  {100 * p['share']:5.1f} %")
    print(f"card: {card.strip()}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card.strip(), rows=rows), indent=1))
    return 0 if all(r["marked_bit_for_bit"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
