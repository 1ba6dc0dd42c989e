"""Timing / power model of the 45nm ODL core + BLE link (paper Table 4, Fig 4).

The port's own copy of ``repro/core/power_model.py`` (pure arithmetic):
every value equals the JAX package's exactly (``tests/test_torch_paper.py``).

We cannot re-run post-layout simulation in this container, so the model is
built from the paper's *published operating points* and calibrated once:

Cycle model (10 MHz core, Table 4):
  * prediction  = CPM_PROJ * (nN + Nm) cycles            (H + O matvecs)
  * seq. train  = prediction-H part + CPM_RLS * rls_ops  (rank-1 Woodbury)
    with rls_ops = 3N^2 + N^2 m + 2Nm + N
  CPM_PROJ and CPM_RLS are calibrated from the two published times at
  (n,N,m) = (561,128,6): 36.40 ms and 171.28 ms -> CPM_PROJ ~ 5.02,
  CPM_RLS ~ 9.07 cycles/op.  The model then *predicts* times for other shapes.

Energy model (Fig. 4):
  E(q, T) = E_pred + q (E_train + E_comm) + P_sleep (T - t_pred - q(t_train + t_comm))
  per event of period T, where q = communication volume (fraction of events
  that query the teacher; Fig. 3's line).  E_comm is the effective BLE energy
  per query (nRF52840, 1 Mbps, 0 dBm, 3.0 V, 561 features x 4 B): raw payload
  energy is ~0.3 mJ, but the Nordic online tool's connection-event overhead
  dominates; we calibrate E_comm to the paper's Auto @ 1 event/s reduction
  (49.4 %) -> E_comm ~ 10.69 mJ/query, then *validate* against the untouched
  1/5 s and 1/10 s cases: model gives 34.6 % and 25.2 % vs paper's 34.7 % and
  25.2 % (the JAX package's tests/test_models_analytic.py).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.memory_model import CoreShape

# --- Published operating points (Table 4) ----------------------------------
FREQ_HZ = 10e6
T_PRED_MS = 36.40
T_TRAIN_MS = 171.28
P_PRED_MW = 3.39
P_TRAIN_MW = 3.37
P_IDLE_MW = 3.06
P_SLEEP_MW = 1.33

# --- BLE link (paper §3.3) --------------------------------------------------
BLE_RATE_BPS = 1e6
BLE_SUPPLY_V = 3.0
BLE_TX_CURRENT_A = 4.8e-3  # nRF52840 @ 0 dBm, DC/DC, 3 V
QUERY_BYTES_UP = 561 * 4
QUERY_BYTES_DOWN = 1
# Effective energy per query, calibrated once to Fig. 4 "Auto" @ 1 event/s
# (includes BLE connection-event/protocol overhead beyond raw payload).
E_COMM_UJ = 10_691.0
T_COMM_MS = (QUERY_BYTES_UP + QUERY_BYTES_DOWN) * 8 / BLE_RATE_BPS * 1e3


def _calibration_shape() -> CoreShape:
    return CoreShape(n=561, N=128, m=6)


def proj_ops(s: CoreShape) -> int:
    return s.n * s.N + s.N * s.m


def rls_ops(s: CoreShape) -> int:
    return 3 * s.N * s.N + s.N * s.N * s.m + 2 * s.N * s.m + s.N


def _cpm_proj() -> float:
    s = _calibration_shape()
    return (T_PRED_MS * 1e-3 * FREQ_HZ) / proj_ops(s)


def _cpm_rls() -> float:
    s = _calibration_shape()
    h_cycles = _cpm_proj() * s.n * s.N  # H recomputed inside training
    return (T_TRAIN_MS * 1e-3 * FREQ_HZ - h_cycles) / rls_ops(s)


def predict_time_ms(s: CoreShape, freq_hz: float = FREQ_HZ) -> float:
    return _cpm_proj() * proj_ops(s) / freq_hz * 1e3


def train_time_ms(s: CoreShape, freq_hz: float = FREQ_HZ) -> float:
    cycles = _cpm_proj() * s.n * s.N + _cpm_rls() * rls_ops(s)
    return cycles / freq_hz * 1e3


def raw_ble_energy_uj() -> float:
    """Payload-only BLE energy (for reference; E_COMM_UJ is what Fig.4 needs)."""
    t_s = (QUERY_BYTES_UP + QUERY_BYTES_DOWN) * 8 / BLE_RATE_BPS
    return BLE_SUPPLY_V * BLE_TX_CURRENT_A * t_s * 1e6


@dataclasses.dataclass(frozen=True)
class EventEnergy:
    """Per-event energy breakdown [uJ] during the training mode."""

    predict: float
    train: float
    comm: float
    sleep: float

    @property
    def total(self) -> float:
        return self.predict + self.train + self.comm + self.sleep


def event_energy_uj(
    q: float, period_s: float, s: CoreShape | None = None
) -> EventEnergy:
    """Energy of one sense->predict->(query+train)? cycle with query rate q.

    q = communication volume fraction (1.0 = no pruning).  The logic part
    powers off outside active windows (paper: stateless logic), so inactive
    time burns P_SLEEP (SRAM retention).
    """
    s = s or _calibration_shape()
    t_pred = predict_time_ms(s)
    t_train = train_time_ms(s)
    e_pred = P_PRED_MW * t_pred  # mW * ms = uJ
    e_train = P_TRAIN_MW * t_train
    sleep_ms = period_s * 1e3 - t_pred - q * (t_train + T_COMM_MS)
    return EventEnergy(
        predict=e_pred,
        train=q * e_train,
        comm=q * E_COMM_UJ,
        sleep=P_SLEEP_MW * max(sleep_ms, 0.0),
    )


def avg_power_mw(q: float, period_s: float, s: CoreShape | None = None) -> float:
    return event_energy_uj(q, period_s, s).total / (period_s * 1e3)


def power_reduction_pct(q: float, period_s: float, s: CoreShape | None = None) -> float:
    """Fig. 4's metric: % reduction vs no pruning (q = 1)."""
    base = avg_power_mw(1.0, period_s, s)
    return 100.0 * (base - avg_power_mw(q, period_s, s)) / base


# Paper Fig. 4 ground truth: power reduction with Auto theta (q = 0.443).
PAPER_AUTO_COMM_VOLUME = 1.0 - 0.557
PAPER_AUTO_REDUCTION = {1.0: 49.4, 5.0: 34.7, 10.0: 25.2}
# Paper Table 4 ground truth.
PAPER_TABLE4 = {
    "predict_ms": T_PRED_MS,
    "train_ms": T_TRAIN_MS,
    "predict_mw": P_PRED_MW,
    "train_mw": P_TRAIN_MW,
    "idle_mw": P_IDLE_MW,
    "sleep_mw": P_SLEEP_MW,
}
