"""Fused rank-k RLS (OS-ELM) update on Hopper: the small-operand stage and
the launch wrapper of ``csrc/oselm_update.cu``.

Replaces the Pallas TPU kernels ``repro/kernels/oselm_update.py::
oselm_rls_update_fleet`` (``_rls_fleet_kernel``) and, as its S = 1 case,
``oselm_rls_update`` (``_rls_kernel``).  The update splits as in the JAX
wrapper:

* small operands, plain torch (``small_operands``): PHt = P Hᵀ,
  S = I + H PHt, G = S⁻¹ PHtᵀ, E = Y − H β, W = Hᵀ E;
* the fused pass, the kernel (``rls_fleet``): P' = P − PHt G and
  β' = β + P' W, each P element read once and written once.

The fused pass is bound by device memory (2·S·N²·4 bytes of P in and out);
see the source for the design.  Plain version: ``ref.rls_fused_ref``.
Device dispatch and the launch count live in ``ops``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


def small_operands(
    P: torch.Tensor,  # (S, N, N)
    beta: torch.Tensor,  # (S, N, m)
    H: torch.Tensor,  # (S, k, N)
    Y: torch.Tensor,  # (S, k, m)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PHt (S, N, k), G (S, k, N) and W (S, N, m), contiguous — the stage the
    JAX wrapper computes outside its ``pallas_call``.

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


@functools.cache
def _launcher():
    lib = build.library("oselm_update")
    fn = lib.oselm_rls_fleet_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.oselm_rls_fleet_error_string.argtypes = [ctypes.c_int]
    lib.oselm_rls_fleet_error_string.restype = ctypes.c_char_p
    return fn, lib.oselm_rls_fleet_error_string


def rls_fleet(
    P: torch.Tensor,  # (S, N, N)
    beta: torch.Tensor,  # (S, N, m)
    pht: torch.Tensor,  # (S, N, k)
    g: torch.Tensor,  # (S, k, N)
    w: torch.Tensor,  # (S, N, m)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused pass on the card; returns new (P', β') buffers.

    Every operand must be a contiguous f32 CUDA tensor on one device with the
    shapes above.  Raises on anything else, and if the launch fails.
    """
    ops_ = {"P": P, "beta": beta, "pht": pht, "g": g, "w": w}
    for name, t in ops_.items():
        if t.device.type != "cuda":
            raise ValueError(f"rls_fleet kernel needs CUDA tensors, {name} is on {t.device}")
        if t.device != P.device:
            raise ValueError(f"{name} is on {t.device}, P on {P.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be 3-d, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    s, n = P.shape[0], P.shape[1]
    k, m = pht.shape[2], beta.shape[2]
    if k < 1 or m < 1:
        raise ValueError(f"rank k and outputs m must be positive, got k={k}, m={m}")
    want = {
        "P": (s, n, n), "beta": (s, n, m), "pht": (s, n, k), "g": (s, k, n), "w": (s, n, m),
    }
    for name, shape in want.items():
        if tuple(ops_[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(ops_[name].shape)}, expected {shape}")
    new_p = torch.empty_like(P)
    new_beta = torch.empty_like(beta)
    if s == 0 or n == 0:
        return new_p, new_beta
    launch, error_string = _launcher()
    with torch.cuda.device(P.device):
        rc = launch(
            P.data_ptr(), beta.data_ptr(), pht.data_ptr(), g.data_ptr(), w.data_ptr(),
            new_p.data_ptr(), new_beta.data_ptr(), s, n, k, m,
            torch.cuda.current_stream(P.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"oselm_update launch failed: {error_string(rc).decode()}")
    return new_p, new_beta
