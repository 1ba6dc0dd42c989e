"""Label acquisition metering (paper §2.2, Fig. 2(c)).

PyTorch counterpart of ``CommMeter`` and ``one_hot`` in
``repro/core/labels.py``.  One query uploads the feature vector (n * 4
bytes, 32-bit values) and downloads one label byte — the paper's BLE
accounting.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device

BYTES_PER_FEATURE = 4  # 32-bit fixed-point features (paper §3.3)
BYTES_PER_LABEL = 1


class CommMeter(NamedTuple):
    """Bytes moved between edge and teacher (f32 accumulators)."""

    up_bytes: torch.Tensor
    down_bytes: torch.Tensor

    @staticmethod
    def zero(device: str | torch.device | None = None) -> "CommMeter":
        device = resolve_device(device)
        return CommMeter(
            torch.zeros((), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.float32, device=device),
        )

    def charge_query(self, n_features: int, queried: torch.Tensor) -> "CommMeter":
        q = queried.to(torch.float32)
        return CommMeter(
            up_bytes=self.up_bytes + q * (n_features * BYTES_PER_FEATURE),
            down_bytes=self.down_bytes + q * BYTES_PER_LABEL,
        )

    @property
    def total(self) -> torch.Tensor:
        return self.up_bytes + self.down_bytes


def one_hot(t: torch.Tensor, n_classes: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(t.long(), n_classes).to(torch.float32)
