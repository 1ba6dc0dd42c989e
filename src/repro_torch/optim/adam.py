"""AdamW with global-norm clipping (PyTorch counterpart of
``repro/optim/adam.py``) and the ZeRO-1 axes helper.

The reference's formula as written, in f32: the gradients are clipped by
their global norm, the moments updated, bias-corrected, and each param moves
by ``lr * (m_hat / (sqrt(v_hat) + 1e-8) + wd * p)``, cast back to its dtype.
Every step is its own f32 operation in the reference's order, so the result
rounds as the reference's does (``torch.optim.AdamW`` decays first, in
another order).  The JAX package computes Adam in XLA ops, outside any
Pallas kernel; so does this module, in plain torch ops.

``update`` writes the new moments and params into the tensors it is given
and returns them (the reference's jitted step donates its state), one
layer slice of a stacked leaf at a time (a large slice in pieces along its
first dim: ``_pieces``), so that at full width it needs no more than a
piece's worth of scratch beside the params, moments and gradients.  The
gradients are scratch too: they are overwritten.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import TrainConfig


class AdamState(NamedTuple):
    step: torch.Tensor  # () int32
    m: dict  # first-moment tree (f32)
    v: dict  # second-moment tree (f32)


def leaves(tree) -> list:
    """A tree's leaves in the reference's order (``jax.tree.leaves``: dict
    keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def init(params) -> AdamState:
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros_like(tree, dtype=torch.float32)

    step = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    return AdamState(step=step, m=zeros(params), v=zeros(params))


def _slices(t: torch.Tensor):
    """A leaf as views whose elementwise update covers it: one per layer of
    a stacked leaf (ndim >= 3), else the leaf itself."""
    return t.unbind(0) if t.dim() >= 3 else (t,)


# Elements: past this a layer's slice is updated in pieces along its first
# dim, so the update's f32 temporaries stay under 256 MB each (a layer of
# deepseek-v2-236b's routed experts is 1.26e9 elements).
_PIECE = 1 << 26


def _pieces(t: torch.Tensor):
    """``_slices(t)``, each cut along its first dim into pieces of at most
    ``_PIECE`` elements where it is larger."""
    for s in _slices(t):
        if s.numel() > _PIECE and s.dim() >= 2:
            yield from s.split(max(1, _PIECE // s[0].numel()))
        else:
            yield s


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    total = 0
    for g in leaves(grads):
        total = total + sum(torch.sum(torch.square(s.float())) for s in _slices(g))
    return torch.sqrt(total)


def update(grads, state: AdamState, params, cfg: TrainConfig, lr_scale: float = 1.0):
    """AdamW step; returns (new_params, new_state, gnorm).  ``params``,
    ``state.m`` and ``state.v`` are updated in place (and returned);
    ``grads`` is overwritten."""
    gnorm = global_norm(grads)
    # A tensor divided by a tensor: ``number / tensor`` is torch's
    # reciprocal-then-multiply, which rounds twice.
    clip_at = torch.full((), cfg.grad_clip, dtype=torch.float32, device=gnorm.device)
    clip = torch.clamp(clip_at / torch.clamp(gnorm, min=1e-9), max=1.0)

    step = state.step + 1
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    lr = cfg.learning_rate * lr_scale

    for g_leaf, m_leaf, v_leaf, p_leaf in zip(
        leaves(grads), leaves(state.m), leaves(state.v), leaves(params), strict=True
    ):
        for g, m, v, p in zip(*map(_pieces, (g_leaf, m_leaf, v_leaf, p_leaf)), strict=True):
            g = g.float() if g.dtype != torch.float32 else g
            p32 = p.float()
            g.mul_(clip)
            t = g * (1 - b1)
            m.mul_(b1).add_(t)  # m2 = b1 m + (1 - b1) g
            torch.mul(g, g, out=t).mul_(1 - b2)
            v.mul_(b2).add_(t)  # v2 = b2 v + (1 - b2) g^2
            torch.div(v, bc2, out=t).sqrt_().add_(1e-8)  # sqrt(v2 / bc2) + 1e-8
            torch.div(m, bc1, out=g).div_(t)  # (m2 / bc1) / (...)
            torch.mul(p32, cfg.weight_decay, out=t)
            g.add_(t).mul_(lr)  # lr (m_hat / (...) + wd p)
            if p.dtype == torch.float32:
                p.sub_(g)
            else:
                p.copy_(p32 - g)
    return params, AdamState(step=step, m=state.m, v=state.v), gnorm


def zero1_axes(axes: tuple, shape: tuple, data_divisor: int) -> tuple:
    """ZeRO-1: extend a param's logical axes for its optimizer moments by
    sharding the first replicated-and-divisible dim over the data axis.

    E.g. a TP-sharded (d, ff) weight with axes ('embed', 'mlp') -> moments
    axes ('zero1', 'mlp'), halving optimizer-state memory per data shard.
    """
    out = list(axes)
    for i, (ax, dim) in enumerate(zip(axes, shape)):
        if ax in (None, "embed", "head_dim", "expert_cap") and dim % data_divisor == 0 \
                and dim >= data_divisor:
            out[i] = "zero1"
            break
    return tuple(out)
