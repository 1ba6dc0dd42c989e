"""Label acquisition via a teacher device (paper §2.2, Fig. 2(c)).

PyTorch counterpart of ``repro/core/labels.py``.  One query uploads the
feature vector (n * 4 bytes, 32-bit values) and downloads one label byte —
the paper's BLE accounting.  In the paper's evaluation the dataset's labels
play the teacher (``ArrayTeacher``); ``ModelTeacher`` wraps any predictor,
such as a backbone ensemble.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

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


@dataclasses.dataclass(frozen=True)
class ArrayTeacher:
    """Teacher whose answers are a precomputed label array (paper's eval)."""

    labels: torch.Tensor  # (T,) int32

    def __call__(self, idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        del x
        return self.labels[idx]


@dataclasses.dataclass(frozen=True)
class ModelTeacher:
    """Teacher backed by a predictor fn(x) -> class (e.g. a backbone ensemble)."""

    predict_fn: Callable[[torch.Tensor], torch.Tensor]

    def __call__(self, idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        del idx
        return self.predict_fn(x)


def acquire(
    teacher: Callable,
    idx: torch.Tensor,
    x: torch.Tensor,
    queried: torch.Tensor,
    n_classes: int,
    meter: CommMeter,
) -> tuple[torch.Tensor, torch.Tensor, CommMeter]:
    """Fig. 2(c): returns (t, y_onehot, meter').

    The teacher is always asked (the reference traces it under jit, so its
    shapes stay static), but communication is charged only where
    ``queried``."""
    t = teacher(idx, x)
    y = one_hot(t, n_classes)
    meter = meter.charge_query(x.shape[-1], queried)
    return t, y, meter
