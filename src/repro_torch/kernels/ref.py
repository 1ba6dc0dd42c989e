"""Plain PyTorch versions of the two hand-written kernels.

Each function here states the exact arithmetic the corresponding CUDA kernel
(``csrc/xorshift_proj.cu``, ``csrc/oselm_update.cu``) computes.  The wrappers
in ``ops`` run them for CPU tensors; on the card they run only in tests and
in ``chip_smoke.py``, which hold the kernels against them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import xorshift


def activate(z: torch.Tensor, kind: str) -> torch.Tensor:
    """The OS-ELM activations (``repro.core.oselm._activate``)."""
    if kind == "sigmoid":
        return torch.sigmoid(z)
    if kind == "relu":
        return torch.relu(z)
    if kind == "tanh":
        return torch.tanh(z)
    if kind == "identity":
        return z
    raise ValueError(f"unknown activation {kind!r}")


def xorshift_projection_ref(
    x: torch.Tensor,
    seed: int,
    n_hidden: int,
    scale: float = 1.0,
    activation: str = "sigmoid",
) -> torch.Tensor:
    """H = act(x @ (alpha(seed) * scale) / sqrt(n_in)) with the counter-based
    alpha materialized; x: (..., n_in) f32 or bf16 -> (..., n_hidden) f32.

    Transcribes ``repro.kernels.ref.xorshift_projection_ref``, and also takes
    tanh, as ``repro.core.oselm.hidden`` does.
    """
    n_in = x.shape[-1]
    alpha = xorshift.alpha_hash(seed, n_in, n_hidden, device=x.device)
    z = x.to(torch.float32) @ (alpha * scale)
    z = z / float(np.sqrt(np.float32(n_in)))
    return activate(z, activation)


def rls_fused_ref(
    P: torch.Tensor,  # (S, N, N)
    beta: torch.Tensor,  # (S, N, m)
    pht: torch.Tensor,  # (S, N, k)
    g: torch.Tensor,  # (S, k, N)
    w: torch.Tensor,  # (S, N, m)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused pass of the Pallas RLS kernels: ``P' = P - PHt @ G`` and
    ``beta' = beta + P' @ W`` (no symmetrisation; beta' from P')."""
    new_p = P - torch.bmm(pht, g)
    return new_p, beta + torch.bmm(new_p, w)
