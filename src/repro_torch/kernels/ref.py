"""Plain PyTorch versions of the hand-written kernels.

Each function here states the arithmetic the corresponding CUDA kernel
(``csrc/xorshift_proj.cu``, ``csrc/oselm_update.cu``, ``csrc/plan_rows.cu``)
computes.  The wrappers
in ``ops`` run them for CPU tensors; on the card they run only in tests and
in ``chip_smoke.py``, which hold the kernels against them — apart from
``small_operands``, which is also the first stage of the two-stage RLS route.
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
    alpha = xorshift.alpha_hash(seed, n_in, n_hidden, device=x.device) * scale
    x2 = x.to(torch.float32).reshape(-1, n_in)
    # One (1, n_in) x (n_in, N) product per row, as the kernel sums each row
    # on its own: on the CPU a plain ``x @ alpha`` picks its routine by the
    # number of rows (one to four rows at n_in = 561 sum in another order),
    # and a cohort's stacked rows must equal each member's own.
    z = torch.bmm(x2[:, None, :], alpha.expand(x2.shape[0], n_in, n_hidden))[:, 0]
    z = z / float(np.sqrt(np.float32(n_in)))
    return activate_rows(z, activation).reshape(x.shape[:-1] + (n_hidden,))


# Elements per call of ``activate_rows`` on the CPU: a multiple of every
# SIMD width, and below the size at which torch splits a loop across threads.
_CPU_SLAB = 16384


def activate_rows(z: torch.Tensor, kind: str) -> torch.Tensor:
    """``activate(z, kind)`` whose value at an element does not depend on how
    many rows ``z`` has.  On the CPU torch finishes a tensor's tail in scalar
    code whose exp rounds otherwise than its vector code (the sigmoid of one
    16-wide row differs in the last bit from the same row inside a longer
    tensor), so there the activation runs over zero-padded slabs that the
    vector code covers whole.  On the card every element is computed alike."""
    if z.device.type != "cpu":
        return activate(z, kind)
    flat = z.reshape(-1)
    n = flat.numel()
    pad = -n % 64
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    out = torch.cat([activate(flat[i:i + _CPU_SLAB], kind)
                     for i in range(0, flat.numel(), _CPU_SLAB)])
    return out[:n].reshape(z.shape)


def readout_ref(h: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Per-stream readout o[s] = h[s] @ beta[s]: h (S, N), beta (S, N, m) -> (S, m)."""
    return torch.einsum("sn,snm->sm", h, beta)


def row_abs_mean_ref(x: torch.Tensor) -> torch.Tensor:
    """The drift detector's feature term mean(|x[s]|): x (S, n) -> (S,) f32."""
    return torch.mean(torch.abs(x.to(torch.float32)), dim=-1)


def small_operands(
    P: torch.Tensor,  # (S, N, N)
    beta: torch.Tensor,  # (S, N, m)
    H: torch.Tensor,  # (S, k, N)
    Y: torch.Tensor,  # (S, k, m)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PHt (S, N, k), G (S, k, N) and W (S, N, m), contiguous — the stage the
    JAX wrapper computes outside its ``pallas_call``: PHt = P Hᵀ,
    S = I + H PHt, G = S⁻¹ PHtᵀ, E = Y − H β, W = Hᵀ E.

    The k x k solve uses ``solve_ex``: like ``jnp.linalg.solve`` it does not
    check for a singular S (S = I + H P Hᵀ is SPD for an SPD P), and unlike
    ``linalg.solve`` it does not make the host wait for the card to check.
    """
    k = H.shape[1]
    pht = torch.einsum("snj,skj->snk", P, H)
    ss = torch.eye(k, dtype=torch.float32, device=P.device) + torch.einsum(
        "skn,snj->skj", H, pht
    )
    g = torch.linalg.solve_ex(ss, pht.transpose(1, 2)).result
    e = Y.to(torch.float32) - torch.einsum("skn,snm->skm", H, beta)
    w = torch.einsum("skn,skm->snm", H, e)
    return pht.contiguous(), g.contiguous(), w.contiguous()


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


def rls_update_ref(
    P: torch.Tensor,  # (S, N, N)
    beta: torch.Tensor,  # (S, N, m)
    H: torch.Tensor,  # (S, k, N)
    Y: torch.Tensor,  # (S, k, m)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole rank-k RLS update with the Pallas numerics: the small
    operands, then the fused pass.  The plain version of both routes."""
    return rls_fused_ref(P, beta, *small_operands(P, beta, H, Y))
