"""One benchmark per paper table/figure, on the port.

Counterpart of the JAX package's ``benchmarks/paper_tables.py``: the same
functions, row names, ``(name, value, derived)`` CSV rows and trial counts.
Each function returns its rows and prints a human-readable block;
``repro_torch.benchmarks.run`` aggregates them.  The drift-protocol tables
(2, 3, Figs 3-4) take ``device``: CUDA unless the caller names another.
Tables 1 and 4 and Fig 4's mW are the analytic models
(``core/memory_model.py``, ``core/power_model.py``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.core import memory_model as mm
from repro_torch.core import power_model as pm


def table1_memory():
    """Paper Table 1: ODL core memory size [kB] vs hidden nodes N."""
    got = mm.table1()
    rows = []
    print("\n== Table 1: memory size [kB] (n=561, m=6) ==")
    print(f"{'N':>5} {'NoODL':>9} {'ODLBase':>9} {'ODLHash':>9}   (paper values in parens)")
    for i, n in enumerate(got["hidden"]):
        print(
            f"{n:>5} {got['noodl'][i]:>9.2f} {got['base'][i]:>9.2f} {got['hash'][i]:>9.2f}"
            f"   ({mm.PAPER_TABLE1['noodl'][i]} / {mm.PAPER_TABLE1['base'][i]} / {mm.PAPER_TABLE1['hash'][i]})"
        )
        for var in ("noodl", "base", "hash"):
            rows.append((f"table1/{var}/N{n}_kB", got[var][i],
                         f"paper={mm.PAPER_TABLE1[var][i]}"))
    return rows


def table2_params(trials: int = 3, device=None):
    """Paper Table 2: parameter count + accuracy of ODLHash."""
    rows = []
    print("\n== Table 2: params + accuracy ==")
    for n_hidden, paper_acc in ((128, 93.67), (256, 95.51)):
        params = mm.odl_param_count(mm.CoreShape(N=n_hidden))
        accs = [
            common.drift_trial(s, theta=1.0, n_hidden=n_hidden, device=device)["before"]
            for s in range(trials)
        ]
        acc = 100 * float(np.mean(accs))
        print(f"ODLHash N={n_hidden}: params={params/1000:.0f}k acc={acc:.2f}% "
              f"(paper: {mm.PAPER_TABLE2[n_hidden]/1000:.0f}k, {paper_acc}%)")
        rows.append((f"table2/N{n_hidden}/params", params, f"paper~{mm.PAPER_TABLE2[n_hidden]}"))
        rows.append((f"table2/N{n_hidden}/acc_pct", acc, f"paper={paper_acc}"))
    return rows


PAPER_TABLE3 = {
    ("noodl", 128): (92.9, 82.9), ("base", 128): (93.4, 90.8), ("hash", 128): (93.1, 90.7),
    ("noodl", 256): (95.1, 83.7), ("base", 256): (95.2, 92.5), ("hash", 256): (95.1, 92.3),
}


def table3_drift(trials: int = 5, device=None):
    """Paper Table 3: accuracy before/after drift, ODL variants vs NoODL."""
    rows = []
    print("\n== Table 3: accuracy before/after drift [%] ==")
    for n_hidden in (128, 256):
        for variant in ("base", "hash"):
            runs = [common.drift_trial(s, 1.0, n_hidden, variant, device=device)
                    for s in range(trials)]
            b_m, b_s = common.mean_std(runs, "before")
            a_m, a_s = common.mean_std(runs, "after")
            no_m, _ = common.mean_std(runs, "noodl_after")
            pb, pa = PAPER_TABLE3[(variant, n_hidden)]
            pno = PAPER_TABLE3[("noodl", n_hidden)][1]
            print(
                f"ODL{variant.capitalize():<5} N={n_hidden}: before {100*b_m:.1f}±{100*b_s:.1f}"
                f" after {100*a_m:.1f}±{100*a_s:.1f} | NoODL after {100*no_m:.1f}"
                f"   (paper {pb}/{pa}, NoODL {pno})"
            )
            rows.append((f"table3/{variant}/N{n_hidden}/before_pct", 100 * b_m, f"paper={pb}"))
            rows.append((f"table3/{variant}/N{n_hidden}/after_pct", 100 * a_m, f"paper={pa}"))
            rows.append((f"table3/noodl/N{n_hidden}/after_pct", 100 * no_m, f"paper={pno}"))
    return rows


def fig3_pruning(trials: int = 5, device=None):
    """Paper Fig. 3: comm volume + accuracy vs theta (incl. auto)."""
    rows = []
    print("\n== Fig. 3: data pruning sweep (N=128, ODLHash) ==")
    base_after = None
    for theta in (1.0, 0.64, 0.32, 0.16, 0.08, 0.01, "auto"):
        runs = [common.drift_trial(s, theta, device=device) for s in range(trials)]
        a_m, a_s = common.mean_std(runs, "after")
        c_m, _ = common.mean_std(runs, "comm")
        if theta == 1.0:
            base_after = a_m
        tag = f"theta={theta}"
        extra = ""
        if theta == "auto":
            extra = (f"  comm reduction {100*(1-c_m):.1f}% (paper 55.7%), "
                     f"acc delta {100*(a_m-base_after):+.1f}% (paper -0.9%)")
        print(f"{tag:>12}: after {100*a_m:.1f}±{100*a_s:.1f}%  comm {100*c_m:.1f}%{extra}")
        rows.append((f"fig3/{theta}/after_pct", 100 * a_m, ""))
        rows.append((f"fig3/{theta}/comm_pct", 100 * c_m, ""))
    return rows


def fig4_power(trials: int = 3, device=None):
    """Paper Fig. 4: training-mode power vs theta at 1/5/10 s event periods."""
    rows = []
    print("\n== Fig. 4: power consumption vs theta ==")
    for theta in (1.0, 0.32, 0.16, 0.08, "auto"):
        runs = [common.drift_trial(s, theta, device=device) for s in range(trials)]
        comm, _ = common.mean_std(runs, "comm")
        line = f"theta={theta:>5}: comm={100*comm:5.1f}%"
        for period in (1.0, 5.0, 10.0):
            mw = pm.avg_power_mw(comm, period)
            red = pm.power_reduction_pct(comm, period)
            line += f"  | {period:>4.0f}s: {mw:6.3f} mW (-{red:4.1f}%)"
            rows.append((f"fig4/{theta}/{int(period)}s_mw", mw, f"reduction={red:.1f}%"))
        print(line)
    print(f"(paper Auto reductions: {pm.PAPER_AUTO_REDUCTION})")
    return rows


def table4_core():
    """Paper Table 4: execution time/power of the core (calibrated model)."""
    rows = []
    print("\n== Table 4: ODL core @10 MHz (cycle/power model) ==")
    s = mm.CoreShape()
    ours = {
        "predict_ms": pm.predict_time_ms(s),
        "train_ms": pm.train_time_ms(s),
        "predict_mw": pm.P_PRED_MW,
        "train_mw": pm.P_TRAIN_MW,
        "idle_mw": pm.P_IDLE_MW,
        "sleep_mw": pm.P_SLEEP_MW,
    }
    for k, v in ours.items():
        print(f"{k:>12}: {v:8.2f}   (paper {pm.PAPER_TABLE4[k]})")
        rows.append((f"table4/{k}", v, f"paper={pm.PAPER_TABLE4[k]}"))
    # Model extrapolations beyond the paper's single published point:
    for n_hidden in (64, 256):
        sh = mm.CoreShape(N=n_hidden)
        rows.append((f"table4/predict_ms_N{n_hidden}", pm.predict_time_ms(sh), "model extrapolation"))
        rows.append((f"table4/train_ms_N{n_hidden}", pm.train_time_ms(sh), "model extrapolation"))
    return rows
