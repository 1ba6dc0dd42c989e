"""Where the hand-written kernels' shape choices cross over on the card, and
one checkout's kernels against another's.

* The projection (``kernels/xorshift_proj.py``) of B rows of n_in into 128:
  device ms by its plan, by the one pass and by a split of K (with the
  split's workspace bytes), and cuBLAS f32 on a stored alpha as the
  yardstick.  ``xorshift_proj.SPLIT_MAX_BLOCKS`` is where the split stops
  paying.
* The single-pass RLS update of one head at (1, 128, k, 6): device ms under
  one block and under a cluster of four blocks of 32 rows, each with as
  many stages as fit.  ``oselm_update.SPREAD_MIN_K`` is where the cluster
  starts paying.  (``rls_breakdown`` takes the chosen plan apart.)
* The kernels at the paths' shapes, each by its checkout's own plan: the
  fleet's projection at N = 128 and 256, the serve and training
  projections, the fleet's RLS update at N = 128 and 256 (the latter also
  by single calls), the paper trial's at N = 256 and the training path's
  one-head update.  ``--rls`` times the RLS rows of this list alone.  Each
  RLS row also has a digest of its outputs (P', β') on inputs drawn from
  fixed seeds, so that two checkouts' rows can be held bit for bit.

``--root PATH`` imports the port of the checkout at PATH instead of this
one (its ``src`` first on the path), so that two checkouts are timed by one
piece of code; the crossover rows need this tree's plan keywords and are
left out for a checkout without them.  Run on a machine with a card, by
path, not as a module (so that PATH's package is the one imported):

    python3 src/repro_torch/benchmarks/kernel_routes.py [--root PATH] [--rls] [--out FILE]

It prints one JSON line, also written to ``--out``.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

SLEEP_CYCLES = 200_000_000  # about 0.1 s of device time ahead of each timed batch
ROUTE_SHAPES = [(b, 561) for b in (256, 1024, 2048, 3072, 4096, 8192, 16384)] + [
    (256, 2560), (32, 2560), (256, 5120), (8, 5120), (1, 561)]
PATH_PROJ = [(16384, 561, 128), (16384, 561, 256), (256, 2560, 128), (32, 2560, 128),
             (8, 5120, 128), (1, 561, 128)]
PATH_RLS = [(16384, 128, 1, 6), (1, 128, 32, 6), (1, 128, 8, 6), (1, 256, 1, 6)]
SPREAD_RANKS = (1, 2, 4, 8, 16, 32, 64)


def _device_ms(fn, reps: int = 50, rounds: int = 3) -> float:
    """Device ms of one call: CUDA events around ``reps`` calls queued behind
    a sleep of the card (so the host's launches are hidden), the median of
    ``rounds``; raises if the host took longer than the sleep to enqueue."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    b.record()
    b.synchronize()
    sleep_ms = a.elapsed_time(b)
    times = []
    for _ in range(rounds):
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        b.record()
        b.synchronize()
        if host_ms >= sleep_ms:
            raise RuntimeError(f"the host took {host_ms:.1f} ms to enqueue {reps} calls, "
                               f"longer than the {sleep_ms:.1f} ms sleep")
        times.append(a.elapsed_time(b) / reps)
    return sorted(times)[len(times) // 2]


def _call_ms(fn, reps: int = 5) -> float:
    """Device ms of single calls from an idle card, the median of ``reps``."""
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
    return sorted(times)[len(times) // 2]


def _rls_inputs(s, n, k, m, seed):
    """An SPD P, beta, H and one-hot Y of s streams on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(s, n, n, generator=g, device="cuda") / n ** 0.5
    P = torch.bmm(a, a.transpose(1, 2)) + 0.1 * torch.eye(n, device="cuda")
    del a
    beta = 0.1 * torch.randn(s, n, m, generator=g, device="cuda")
    H = torch.sigmoid(torch.randn(s, k, n, generator=g, device="cuda"))
    Y = torch.nn.functional.one_hot(
        torch.randint(0, m, (s, k), generator=g, device="cuda"), m).to(torch.float32)
    return P, beta, H, Y


def _digest(out) -> str:
    """The first 16 hex digits of the SHA-256 of (P', β')'s bytes."""
    h = hashlib.sha256()
    for t in out:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(rls_only: bool = False) -> dict:
    import torch

    from repro_torch.core import xorshift
    from repro_torch.kernels import build, oselm_update, xorshift_proj

    build.build_all()
    g = torch.Generator(device="cuda").manual_seed(0)
    out: dict = {"path": {}, "digests": {}, "routes": [], "spread": []}
    for b, n_in, n in [] if rls_only else PATH_PROJ:
        # Three x in turn: at the fleet's rows one is 36.8 MB, and x comes
        # from device memory, not the 50 MB L2, as in a fleet tick.
        xs = [torch.randn(b, n_in, generator=g, device="cuda") for _ in range(3)]
        turn = iter(range(10 ** 9))
        out["path"][f"projection {b}x{n_in}x{n}"] = _device_ms(
            lambda: xorshift_proj.xorshift_projection(xs[next(turn) % 3], 0x2D2A, n))
        del xs
    for shape in PATH_RLS:
        P, beta, H, Y = _rls_inputs(*shape, seed=5)
        out["path"][f"rls {shape}"] = _device_ms(lambda: oselm_update.rls_single(P, beta, H, Y))
        out["digests"][f"rls {shape}"] = _digest(oselm_update.rls_single(P, beta, H, Y))
        del P, beta, H, Y
    P, beta, H, Y = _rls_inputs(16384, 256, 1, 6, seed=9)
    out["path"]["rls (16384, 256, 1, 6)"] = _device_ms(
        lambda: oselm_update.rls_single(P, beta, H, Y), reps=8)
    out["path"]["rls (16384, 256, 1, 6) single calls"] = _call_ms(
        lambda: oselm_update.rls_single(P, beta, H, Y))
    out["digests"]["rls (16384, 256, 1, 6)"] = _digest(oselm_update.rls_single(P, beta, H, Y))
    del P, beta, H, Y
    if rls_only:
        return out

    if hasattr(xorshift_proj, "projection_plan"):
        for b, n_in in ROUTE_SHAPES:
            x = torch.randn(b, n_in, generator=g, device="cuda")
            alpha = xorshift.alpha_hash(0x2D2A, n_in, 128, device="cuda")
            c = float(1.0 / n_in ** 0.5)
            row = {"shape": [b, n_in, 128]}
            for label, smb in (("plan", xorshift_proj.SPLIT_MAX_BLOCKS), ("one_pass", 0),
                               ("split", 10 ** 6)):
                plan = xorshift_proj.projection_plan(b, n_in, 128, split_max_blocks=smb)
                row[label] = dict(grid=list(plan.grid), workspace_bytes=plan.workspace_bytes,
                                  ms=_device_ms(lambda: xorshift_proj.xorshift_projection(
                                      x, 0x2D2A, 128, plan=plan)))
            row["cublas_ms"] = _device_ms(lambda: torch.sigmoid(torch.matmul(x, alpha) * c))
            out["routes"].append(row)
            del x, alpha
    if "plan" in inspect.signature(oselm_update.rls_single).parameters:
        for k in SPREAD_RANKS:
            P, beta, H, Y = _rls_inputs(1, 128, k, 6, seed=100 + k)
            row = {"k": k, "plan": list(oselm_update.single_pass_plan(128, k, 6))}
            for c in (1, 4):
                ns = max(s for s in range(1, oselm_update.MAX_STAGES + 1)
                         if oselm_update.single_pass_smem_bytes(128, k, 6, c, s)
                         <= oselm_update.MAX_SMEM_BYTES)
                row[f"{c}x{ns}_ms"] = _device_ms(
                    lambda: oselm_update.rls_single(P, beta, H, Y, plan=(c, ns)))
            out["spread"].append(row)
            del P, beta, H, Y
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[3],
                    help="the checkout whose port is timed (default: this one)")
    ap.add_argument("--rls", action="store_true",
                    help="time the RLS update at the paths' shapes only")
    ap.add_argument("--out", default=None, help="write the JSON line here too")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve() / "src"))
    import torch

    if not torch.cuda.is_available():
        print("kernel_routes: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    line = json.dumps(dict(root=str(args.root.resolve()), package=repro_torch.__file__,
                           card=card.strip(), **measure(args.rls)))
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
