"""OS-ELM: Online Sequential Extreme Learning Machine (paper §2.1).

PyTorch counterpart of ``repro/core/oselm.py``.  Single-hidden-layer
network; ``alpha`` (input->hidden) is fixed random and never trained,
``beta`` (hidden->output) is trained by recursive least squares (rank-k
Woodbury update of the inverse Gram matrix ``P``):

    H   = G(x @ alpha)                                  (k, N)
    S   = I_k + H P H^T                                 (k, k)
    P'  = P - P H^T S^{-1} H P                          (N, N)
    beta' = beta + P' H^T (Y - H beta)                  (N, m)

Variants (paper §2.3):
  * ``base`` — alpha stored dense (ODLBase).  The caller passes alpha (made
    with numpy, or carried across from the JAX package): the port does not
    reproduce JAX's threefry bits.
  * ``hash`` — alpha regenerated on the fly from Xorshift16 (ODLHash),
    through the projection kernel (``kernels/ops.xorshift_projection``).

Every RLS update runs the fused kernel's numerics (``kernels/ops``): no
symmetrisation of P', beta' from P' @ W.  ``cfg.use_kernel`` is kept so
configs carry across from the JAX package, but the device of the tensors,
not the flag, chooses between kernel (CUDA) and plain version (CPU).

A fleet of heads is a leading stream axis S on every ``OSELMState`` leaf.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import xorshift
from repro_torch.kernels import ops
from repro_torch.kernels.ref import activate


@dataclasses.dataclass(frozen=True)
class OSELMConfig:
    n_in: int = 561
    n_hidden: int = 128
    n_out: int = 6
    variant: str = "hash"  # 'base' | 'hash'
    seed: int = xorshift.DEFAULT_SEED
    activation: str = "sigmoid"  # 'sigmoid' | 'relu' | 'tanh' | 'identity'
    ridge: float = 1e-2  # epsilon for P_0 = (H0^T H0 + ridge I)^{-1}
    alpha_scale: float = 1.0  # scales alpha; sigmoid saturates if n_in large
    use_kernel: bool = False  # kept for config parity; the device picks the path

    def replace(self, **kw) -> "OSELMConfig":
        return dataclasses.replace(self, **kw)


class OSELMState(NamedTuple):
    """Trainable state of one ODL head (leading S axis for a fleet)."""

    beta: torch.Tensor  # (N, m) f32
    P: torch.Tensor  # (N, N) f32 inverse Gram
    count: torch.Tensor  # () int32 — samples trained so far


def hidden(
    x: torch.Tensor, cfg: OSELMConfig, alpha: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Hidden activations H = G(x @ alpha * scale / sqrt(n)).  x: (..., n_in).

    ``hash`` goes through the projection kernel, which scales and activates
    in its epilogue (with ``cfg.activation``); nothing is applied twice.
    ``base`` needs ``alpha`` (n_in, N), already scaled.
    """
    if cfg.variant == "hash":
        return ops.xorshift_projection(
            x, cfg.seed, cfg.n_hidden, scale=cfg.alpha_scale, activation=cfg.activation
        )
    if cfg.variant != "base":
        raise ValueError(f"unknown ODL variant: {cfg.variant!r}")
    if alpha is None:
        raise ValueError("variant 'base' needs its stored alpha (n_in, n_hidden)")
    inv_sqrt_n = float(np.float32(1.0) / np.sqrt(np.float32(cfg.n_in)))
    z = torch.matmul(x.to(torch.float32), alpha.to(x.device, torch.float32))
    return activate(z * inv_sqrt_n, cfg.activation)


def init_state(cfg: OSELMConfig, device: str | torch.device | None = None) -> OSELMState:
    """Pure-online init: P_0 = I/ridge, beta_0 = 0 (no initial batch needed)."""
    device = resolve_device(device)
    eye = torch.eye(cfg.n_hidden, dtype=torch.float32, device=device)
    return OSELMState(
        beta=torch.zeros((cfg.n_hidden, cfg.n_out), dtype=torch.float32, device=device),
        P=eye / cfg.ridge,
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def init_state_batch(
    cfg: OSELMConfig,
    x0: torch.Tensor,
    y0: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
) -> OSELMState:
    """Classic OS-ELM boot: P_0 = (H0^T H0 + ridge I)^{-1}, beta_0 = P0 H0^T Y0.

    Built on the device of ``x0``; P_0 by a Cholesky solve against I.
    """
    h0 = hidden(x0, cfg, alpha)
    eye = torch.eye(cfg.n_hidden, dtype=torch.float32, device=h0.device)
    gram = h0.T @ h0 + cfg.ridge * eye
    p0 = torch.cholesky_solve(eye, torch.linalg.cholesky(gram))
    beta0 = p0 @ (h0.T @ y0.to(h0.device, torch.float32))
    count = torch.tensor(x0.shape[0], dtype=torch.int32, device=h0.device)
    return OSELMState(beta=beta0, P=p0, count=count)


def predict_logits(
    state: OSELMState, x: torch.Tensor, cfg: OSELMConfig, alpha=None
) -> torch.Tensor:
    """Linear outputs O = H beta (approximate class posteriors)."""
    return hidden(x, cfg, alpha) @ state.beta


def predict(
    state: OSELMState, x: torch.Tensor, cfg: OSELMConfig, alpha=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (predicted class c, outputs O) — Fig. 2(b)."""
    o = predict_logits(state, x, cfg, alpha)
    return torch.argmax(o, dim=-1), o


def sequential_update(
    state: OSELMState,
    x: torch.Tensor,
    y: torch.Tensor,
    cfg: OSELMConfig,
    alpha: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> OSELMState:
    """Rank-k RLS update (Fig. 2(d)).  x: (k, n_in) or (n_in,); y one-hot.

    ``mask`` (k,) in {0,1} soft-deletes rows: a masked row contributes
    exactly nothing (H_row := 0, its innovation zeroed).
    """
    if x.dim() == 1:
        x, y = x[None], y[None]
        if mask is not None:
            mask = mask[None]
    k = x.shape[0]
    h = hidden(x, cfg, alpha)  # (k, N)
    y = y.to(h.device, torch.float32)
    if mask is not None:
        h = h * mask[:, None].to(h.dtype)
        y = y * mask[:, None].to(torch.float32)
    new_p, new_beta = ops.oselm_rls_update(state.P, state.beta, h, y)
    inc = mask.to(torch.int32).sum().to(torch.int32) if mask is not None else k
    return OSELMState(beta=new_beta, P=new_p, count=state.count + inc)


def fit_closed_form(
    cfg: OSELMConfig, x: torch.Tensor, y: torch.Tensor, alpha=None
) -> torch.Tensor:
    """Ridge least-squares solution over the whole dataset (test oracle):
    sequential OS-ELM over all rows converges to this beta."""
    h = hidden(x, cfg, alpha)
    eye = torch.eye(cfg.n_hidden, dtype=torch.float32, device=h.device)
    gram = h.T @ h + cfg.ridge * eye
    return torch.linalg.solve(gram, h.T @ y.to(h.device, torch.float32))


# ---------------------------------------------------------------------------
# Fleet helpers: many independent heads, one per stream (leading axis S).
# ---------------------------------------------------------------------------


def init_fleet(
    cfg: OSELMConfig, n_streams: int, device: str | torch.device | None = None
) -> OSELMState:
    one = init_state(cfg, device)
    return OSELMState(*(a.expand((n_streams,) + a.shape).clone() for a in one))


def fleet_rank1_update_h(
    state: OSELMState,  # leaves with leading S
    h: torch.Tensor,  # (S, N) hidden activations, one row per stream
    y: torch.Tensor,  # (S, m) one-hot targets
    cfg: OSELMConfig,
    mask: Optional[torch.Tensor] = None,  # (S,) in {0, 1}
    out: Optional[tuple[torch.Tensor, torch.Tensor]] = None,  # (P', beta') buffers
) -> OSELMState:
    """Masked rank-1 RLS for S independent heads through the fused kernel.

    Takes precomputed hidden activations so a tick never projects twice.
    A masked stream is an exact identity on (P, beta, count).  With ``out``
    the new P and beta are written into those buffers (the stream runtime's
    ping-pong pair) instead of new ones.
    """
    if mask is None:
        mask = torch.ones(h.shape[0], dtype=torch.float32, device=h.device)
    mask = mask.to(torch.float32)
    hm = h * mask[:, None]
    ym = y.to(torch.float32) * mask[:, None]
    new_p, new_beta = ops.oselm_rls_update_fleet(
        state.P, state.beta, hm[:, None, :], ym[:, None, :], out=out
    )
    return OSELMState(beta=new_beta, P=new_p, count=state.count + mask.to(torch.int32))


def fleet_rank1_update(
    state: OSELMState,
    x: torch.Tensor,  # (S, n_in)
    y: torch.Tensor,  # (S, m)
    cfg: OSELMConfig,
    mask: Optional[torch.Tensor] = None,
) -> OSELMState:
    """As :func:`fleet_rank1_update_h` but projecting ``x`` itself."""
    return fleet_rank1_update_h(state, hidden(x, cfg), y, cfg, mask=mask)
