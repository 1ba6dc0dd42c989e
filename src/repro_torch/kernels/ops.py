"""Device dispatch for the two kernels, and their launch counts.

A CPU tensor goes to the plain PyTorch version (``ref``); a CUDA tensor goes
to the hand-written kernel, and a failed build or launch raises — there is
no fallback.  Any other device raises.

``launch_counts`` holds one plain integer per kernel, raised by one where
the kernel is launched and nowhere else, so a run can show that its main
path went through the kernels (``chip_smoke.py`` reads it).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import oselm_update as _oselm_update
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import xorshift_proj as _xorshift_proj

launch_counts = {"xorshift_projection": 0, "oselm_rls_update_fleet": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"repro_torch kernels run on CUDA or CPU tensors, got {t.device}")


def xorshift_projection(
    x: torch.Tensor,
    seed: int,
    n_hidden: int,
    scale: float = 1.0,
    activation: str = "sigmoid",
) -> torch.Tensor:
    """ODLHash projection H = act(x @ alpha(seed) * scale / sqrt(n_in)).

    Accepts (..., n_in); leading dims are flattened for the kernel.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _on_cuda(x2):
        h = _xorshift_proj.xorshift_projection(
            x2.contiguous(), seed, n_hidden, scale=scale, activation=activation
        )
        launch_counts["xorshift_projection"] += 1
    else:
        h = _ref.xorshift_projection_ref(x2, seed, n_hidden, scale=scale, activation=activation)
    return h.reshape(lead + (n_hidden,))


def oselm_rls_update_fleet(
    P: torch.Tensor, beta: torch.Tensor, H: torch.Tensor, Y: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused rank-k RLS update for S heads: P (S,N,N), beta (S,N,m),
    H (S,k,N), Y (S,k,m) -> new (P', beta'), Pallas numerics."""
    pht, g, w = _oselm_update.small_operands(P, beta, H, Y)
    if _on_cuda(P):
        out = _oselm_update.rls_fleet(P.contiguous(), beta.contiguous(), pht, g, w)
        launch_counts["oselm_rls_update_fleet"] += 1
        return out
    return _ref.rls_fused_ref(P, beta, pht, g, w)


def oselm_rls_update(
    P: torch.Tensor, beta: torch.Tensor, H: torch.Tensor, Y: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused rank-k RLS update of one head: P (N,N), beta (N,m), H (k,N),
    Y (k,m) -> (P', beta').  The S = 1 case of ``oselm_rls_update_fleet``."""
    new_p, new_beta = oselm_rls_update_fleet(P[None], beta[None], H[None], Y[None])
    return new_p[0], new_beta[0]
