"""Benchmark entry point of the port: one function per paper table/figure.

Usage:  python -m repro_torch.benchmarks.run [--trials N] [--skip-drift] [--device cpu]

Prints human-readable blocks followed by a ``name,value,derived`` CSV, as
the JAX package's ``benchmarks/run.py`` does, for its paper rows: Tables 1
and 4 always, Tables 2-3 and Figs 3-4 unless ``--skip-drift``.  The drift
experiments run on CUDA unless ``--device`` names another device.

Left out: that script's ``kernels_bench``, ``fleet_bench`` and ``roofline``
rows.  They time the JAX package's Pallas kernels and fleet on a TPU (or
the CPU); the port's kernel times, bounds and library yardsticks come from
``chip_smoke.py`` (phase 7) on the card instead.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=5,
                    help="drift-protocol repetitions (paper uses 20)")
    ap.add_argument("--skip-drift", action="store_true",
                    help="skip the minutes-long accuracy experiments")
    ap.add_argument("--device", default=None,
                    help="device of the drift experiments (default: cuda)")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.benchmarks import paper_tables

    t0 = time.perf_counter()
    rows = []
    rows += paper_tables.table1_memory()
    rows += paper_tables.table4_core()
    if not args.skip_drift:
        device = resolve_device(args.device)
        rows += paper_tables.table2_params(trials=min(3, args.trials), device=device)
        rows += paper_tables.table3_drift(trials=args.trials, device=device)
        rows += paper_tables.fig3_pruning(trials=args.trials, device=device)
        rows += paper_tables.fig4_power(trials=min(3, args.trials), device=device)

    print("\nname,value,derived")
    for name, value, derived in rows:
        print(f"{name},{value},{derived}")
    print(f"\nwall: {time.perf_counter() - t0:.1f} s")
    return rows


if __name__ == "__main__":
    main()
