"""Plain PyTorch versions of the hand-written kernels.

Each function here states the arithmetic the corresponding CUDA kernel
(``csrc/xorshift_proj.cu``, ``csrc/oselm_update.cu``, ``csrc/plan_rows.cu``)
computes.  The wrappers
in ``ops`` run them for CPU tensors; on the card they run only in tests and
in ``chip_smoke.py``, which hold the kernels against them — apart from
``small_operands``, which is also the first stage of the two-stage RLS route.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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


class PlanRows(NamedTuple):
    """What ``plan`` and ``gate`` compute after the projection: the plan's
    fields of the tick and the new prune, drift and meter leaves."""

    outputs: torch.Tensor  # (S, m) f32 raw outputs o
    pred: torch.Tensor  # (S,) int32 argmax of o
    confidence: torch.Tensor  # (S,) f32 P1P2
    queried: torch.Tensor  # (S,) bool
    controller_on: torch.Tensor  # (S,) bool
    theta: torch.Tensor  # (S,) f32
    mode_training: torch.Tensor  # (S,) bool
    prune: tuple  # PruneState
    drift: tuple  # DriftState
    meter: tuple  # CommMeter


def plan_rows_ref(
    h: torch.Tensor,  # (S, N)
    beta: torch.Tensor,  # (S, N, m)
    x: torch.Tensor,  # (S, n_in)
    count: torch.Tensor,  # (S,) int32, elm.count
    prune,  # PruneState
    drift,  # DriftState
    meter,  # CommMeter
    cfg,  # EngineConfig
    mode: str,
    teacher_available: Optional[torch.Tensor] = None,  # (S,) bool
    drift_active: Optional[torch.Tensor] = None,  # (S,) bool, train_phase only
    o: Optional[torch.Tensor] = None,  # (S, m) the readout, if already computed
    a: Optional[torch.Tensor] = None,  # (S,) the feature mean, if already computed
) -> PlanRows:
    """The plain version of ``csrc/plan_rows.cu``'s fused pass: the part of
    ``engine/fleet.py``'s ``plan`` after the projection, in the torch ops of
    the controllers in ``core/`` (``gate`` is mode ``serve``).  ``o`` and
    ``a`` default to ``readout_ref(h, beta)`` and ``row_abs_mean_ref(x)``; a
    check of the kernel passes the kernel's own, so that the rest is
    compared bit for bit."""
    # Imported here: core/drift.py imports kernels.ops, which imports this module.
    from repro_torch.core import drift as drift_mod
    from repro_torch.core import pruning

    if o is None:
        o = readout_ref(h, beta)
    if a is None and mode != "train_phase" and cfg.drift.use_features:
        a = row_abs_mean_ref(x)
    n_streams = o.shape[0]
    dev = o.device
    if teacher_available is None:
        teacher_available = torch.ones((n_streams,), dtype=torch.bool, device=dev)
    off = torch.zeros((n_streams,), dtype=torch.bool, device=dev)
    c = torch.argmax(o, dim=-1).to(torch.int32)
    conf = pruning.confidence(o)

    if mode == "serve":
        # ``gate`` semantics: live drift detector, a drifting stream is
        # forced to query, the controller is always armed, no training-mode
        # gating — so plan(mode='serve') + learn == gate + apply_labels.
        s = drift_mod.score(x, o, cfg.drift, feature_mean=a)
        new_drift = drift_mod.update(drift, s, cfg.drift)
        training = torch.ones((n_streams,), dtype=torch.bool, device=dev)
        prune_st = prune
        want_query = pruning.should_query(prune_st, o, count, new_drift.active, cfg.prune)
        queried = want_query & teacher_available
        controller_on = teacher_available
    elif mode == "algo1":
        # IsDrift / IsTrainDone: per-stream detector with hysteresis.
        s = drift_mod.score(x, o, cfg.drift, feature_mean=a)
        new_drift = drift_mod.update(drift, s, cfg.drift)
        training = new_drift.active
        # Rising edge == IsDrift fired: re-arm the per-phase counter.
        entering = training & ~drift.active
        prune_st = pruning.select(entering, pruning.reset_phase(prune), prune)
        want_query = pruning.should_query(prune_st, o, count, off, cfg.prune)
        queried = training & want_query & teacher_available
        # Auto-theta only observes training-mode steps with a live teacher.
        controller_on = training & teacher_available
    else:
        if drift_active is None:
            drift_active = off
        new_drift = drift
        training = torch.ones((n_streams,), dtype=torch.bool, device=dev)
        prune_st = prune
        want_query = pruning.should_query(prune_st, o, count, drift_active, cfg.prune)
        queried = want_query & teacher_available
        controller_on = teacher_available

    theta = pruning.theta_of(prune_st, cfg.prune)
    new_meter = meter.charge_query(x.shape[-1], queried)
    # A skipped sample's ladder transition uses only (conf > theta), never
    # the teacher's answer, so it is accounted now.
    new_prune = pruning.select(
        controller_on & ~queried,
        pruning.update(prune_st, off, off, conf, cfg.prune),
        prune_st,
    )
    return PlanRows(outputs=o, pred=c, confidence=conf, queried=queried,
                    controller_on=controller_on, theta=theta, mode_training=training,
                    prune=new_prune, drift=new_drift, meter=new_meter)


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


def fused_elm_head_ref(
    x: torch.Tensor,  # (k, n_in)
    P: torch.Tensor,  # (N, N) f32
    beta: torch.Tensor,  # (N, m) f32
    Y: torch.Tensor,  # (k, m)
    seed: int,
    scale: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projection + RLS update of one head, fused (what the serve and train
    steps run): (H, P', beta').  Transcribes ``repro.kernels.ref.
    fused_elm_head_ref``, with the kernels' RLS numerics (``rls_update_ref``:
    no symmetrisation of P')."""
    h = xorshift_projection_ref(x, seed, P.shape[0], scale)
    new_p, new_beta = rls_update_ref(P[None], beta[None], h[None], Y[None])
    return h, new_p[0], new_beta[0]
