"""Xorshift16 pseudo-random weight generation (paper §2.3, ODLHash).

PyTorch counterpart of ``repro/core/xorshift.py``.  Two semantics:

* ``xorshift16_stream`` — the paper's *sequential* generator (state-machine
  semantics), numpy, host side.
* ``alpha_hash`` — the *counter-based* variant: each entry ``alpha[k, j]``
  is derived independently from ``seed ^ (k*N + j + 1)`` by (7, 9, 8)
  Xorshift16 rounds, each followed by an odd-constant multiply, so any tile
  of the matrix can be generated on its own (what the projection kernel
  does, ``kernels/csrc/xorshift_proj.cu``).

PyTorch has no full uint16 arithmetic, so the u16 values live in int64
lanes masked with ``& 0xFFFF`` after every shift and multiply, the way the
Pallas kernel's ``_mix16_u32`` does it on uint32 lanes.  The result is bit
for bit the uint16 semantics.  Both map u16 lattice points to f32 in [-1, 1)
via ``u16_to_unit``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

# Paper coefficients: x ^= x << 7; x ^= x >> 9; x ^= x << 8  (mod 2^16).
SHIFT_A, SHIFT_B, SHIFT_C = 7, 9, 8
MASK16 = 0xFFFF
DEFAULT_ROUNDS = 3
DEFAULT_SEED = 0x2D2A  # arbitrary nonzero 16-bit constant

# Odd 16-bit constants interleaved between xorshift rounds: xorshift alone is
# linear over GF(2), so sequential counters would give correlated columns.
MIX_CONSTANTS = (0x2D2B, 0x9E35, 0xC2B3)


def xorshift16_step(x: torch.Tensor) -> torch.Tensor:
    """One (7, 9, 8) Xorshift16 step on integer lanes holding u16 values."""
    x = x.to(torch.int64) & MASK16
    x = (x ^ (x << SHIFT_A)) & MASK16
    x = x ^ (x >> SHIFT_B)
    return (x ^ (x << SHIFT_C)) & MASK16


def xorshift16_rounds(x: torch.Tensor, rounds: int = DEFAULT_ROUNDS) -> torch.Tensor:
    """Apply ``rounds`` Xorshift16 steps."""
    for _ in range(rounds):
        x = xorshift16_step(x)
    return x


def u16_to_unit(x: torch.Tensor) -> torch.Tensor:
    """Map u16 -> float32 in [-1, 1): x/32768 - 1."""
    return x.to(torch.float32) * (1.0 / 32768.0) - 1.0


def xorshift16_stream(seed: int, length: int) -> np.ndarray:
    """The paper's sequential Xorshift16 state machine (numpy, host side).

    Zero state is a fixed point of xorshift; seeds are forced nonzero.
    Returns ``length`` uint16 values (the state after each step).
    """
    s = np.uint16(seed if (seed & 0xFFFF) != 0 else 1)
    out = np.empty(length, dtype=np.uint16)
    for i in range(length):
        s = np.uint16(s ^ np.uint16((int(s) << SHIFT_A) & 0xFFFF))
        s = np.uint16(s ^ np.uint16(int(s) >> SHIFT_B))
        s = np.uint16(s ^ np.uint16((int(s) << SHIFT_C) & 0xFFFF))
        out[i] = s
    return out


def mix16(x: torch.Tensor, rounds: int = DEFAULT_ROUNDS) -> torch.Tensor:
    """Counter hash: (xorshift16 round; odd-constant multiply) x rounds.

    Returns int64 lanes holding the u16 result.
    """
    x = x.to(torch.int64) & MASK16
    for r in range(rounds):
        x = xorshift16_step(x)
        x = (x * MIX_CONSTANTS[r % len(MIX_CONSTANTS)]) & MASK16
    return x


def alpha_hash(
    seed: int,
    n_in: int,
    n_hidden: int,
    rounds: int = DEFAULT_ROUNDS,
    row_offset: int = 0,
    col_offset: int = 0,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Counter-based ODLHash weights: the (n_in, n_hidden) f32 matrix

    ``alpha[k, j] = u16_to_unit(mix16(seed ^ (gk*n_hidden + gj + 1)))``

    with global indices ``gk = k + row_offset``, ``gj = j + col_offset``;
    bit-identical to ``repro.core.xorshift.alpha_hash``.
    """
    device = resolve_device(device)
    rows = torch.arange(n_in, dtype=torch.int64, device=device) + row_offset
    cols = torch.arange(n_hidden, dtype=torch.int64, device=device) + col_offset
    ctr = rows[:, None] * n_hidden + cols[None, :] + 1
    x = ((seed & 0xFFFFFFFF) ^ ctr) & MASK16
    x = torch.where(x == 0, torch.full_like(x, 0x9E37), x)  # avoid the zero fixed point
    return u16_to_unit(mix16(x, rounds))
