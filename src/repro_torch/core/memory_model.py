"""Analytic memory / parameter models of the ODL core (paper Tables 1 & 2).

The port's own copy of ``repro/core/memory_model.py`` (pure arithmetic):
every value equals the JAX package's exactly (``tests/test_torch_paper.py``).

Reverse-engineered from the published tables (verified exact to 0.01 kB for
every entry, see the JAX package's tests/test_models_analytic.py):

  NoODL   = 4 (nN + Nm + n)            bytes   (alpha, beta, input buffer)
  ODLBase = 4 (nN + Nm + n + 2 N^2)    bytes   (+ P and its update temporary)
  ODLHash = 4 (Nm + n + 2 N^2)         bytes   (alpha replaced by 16-bit PRNG)

Table 2's "# of parameters" counts the ODL state that must persist across
updates, P (N^2) + beta (Nm), double-buffered: params = 2 (N^2 + Nm)
(ODLHash N=128 -> 34,304 ~ "34k"; N=256 -> 134,144 ~ "133k").
"""

from __future__ import annotations

import dataclasses

BYTES_PER_WORD = 4  # 32-bit fixed point (paper §3.3)


@dataclasses.dataclass(frozen=True)
class CoreShape:
    n: int = 561  # input nodes
    N: int = 128  # hidden nodes
    m: int = 6  # output nodes


def noodl_bytes(s: CoreShape) -> int:
    """Inference-only MLP of the same shape (alpha + beta + input buffer)."""
    return BYTES_PER_WORD * (s.n * s.N + s.N * s.m + s.n)


def odlbase_bytes(s: CoreShape) -> int:
    """ODLBase: NoODL + P (N^2) + P-update temporary (N^2)."""
    return noodl_bytes(s) + BYTES_PER_WORD * 2 * s.N * s.N


def odlhash_bytes(s: CoreShape) -> int:
    """ODLHash: alpha (nN words) replaced by a 16-bit Xorshift seed (~0 B)."""
    return odlbase_bytes(s) - BYTES_PER_WORD * s.n * s.N


def memory_kb(variant: str, s: CoreShape) -> float:
    fn = {"noodl": noodl_bytes, "base": odlbase_bytes, "hash": odlhash_bytes}[variant]
    return fn(s) / 1000.0  # paper uses kB = 1000 B


def odl_param_count(s: CoreShape) -> int:
    """Table 2 parameter count: double-buffered persistent ODL state."""
    return 2 * (s.N * s.N + s.N * s.m)


def table1(n: int = 561, m: int = 6, hidden=(32, 64, 128, 256, 512)):
    """Reproduce paper Table 1: memory size [kB] per variant per N."""
    rows = {}
    for variant in ("noodl", "base", "hash"):
        rows[variant] = [memory_kb(variant, CoreShape(n, N, m)) for N in hidden]
    return {"hidden": list(hidden), **rows}


# Paper Table 1 ground truth for verification [kB].
PAPER_TABLE1 = {
    "hidden": [32, 64, 128, 256, 512],
    "noodl": [74.82, 147.40, 292.55, 582.85, 1163.46],
    "base": [83.01, 180.16, 423.62, 1107.14, 3260.61],
    "hash": [11.20, 36.55, 136.39, 532.68, 2111.68],
}

# Paper Table 2 parameter counts.
PAPER_TABLE2 = {128: 34_000, 256: 133_000}  # reported as "34k" / "133k"
