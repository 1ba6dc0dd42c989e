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
from repro_torch.distributed import sharding


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


def _factors(gnorm, step, cfg: TrainConfig):
    """(clip, bias corrections 1 and 2) of a step: ``step`` is the new
    step count."""
    # A tensor divided by a tensor: ``number / tensor`` is torch's
    # reciprocal-then-multiply, which rounds twice.
    clip_at = torch.full((), cfg.grad_clip, dtype=torch.float32, device=gnorm.device)
    clip = torch.clamp(clip_at / torch.clamp(gnorm, min=1e-9), max=1.0)
    bc1 = 1.0 - cfg.beta1 ** step.to(torch.float32)
    bc2 = 1.0 - cfg.beta2 ** step.to(torch.float32)
    return clip, bc1, bc2


def _apply(g_leaf, m_leaf, v_leaf, p_leaf, clip, bc1, bc2, lr, cfg: TrainConfig) -> None:
    """AdamW on one leaf, piece by piece, in place (``g_leaf`` overwritten)."""
    b1, b2 = cfg.beta1, cfg.beta2
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


def update(grads, state: AdamState, params, cfg: TrainConfig, lr_scale: float = 1.0):
    """AdamW step; returns (new_params, new_state, gnorm).  ``params``,
    ``state.m`` and ``state.v`` are updated in place (and returned);
    ``grads`` is overwritten."""
    gnorm = global_norm(grads)
    step = state.step + 1
    clip, bc1, bc2 = _factors(gnorm, step, cfg)
    for leaf in zip(leaves(grads), leaves(state.m), leaves(state.v), leaves(params), strict=True):
        _apply(*leaf, clip, bc1, bc2, cfg.learning_rate * lr_scale, cfg)
    return params, AdamState(step=step, m=state.m, v=state.v), gnorm


# ---------------------------------------------------------------------------
# The partitioned update: params and moments held as ``sharding.Sharded``
# ---------------------------------------------------------------------------


def _paths(tree, path=()):
    """The key path of each leaf of a tree of dicts, in ``leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    else:
        yield path


def _entries(spec, n: int) -> list:
    return [tuple(sharding.axes_of(e)) for e in list(spec) + [None] * (n - len(spec))]


def reduce_to_moments(g: dict, held, moments, mesh) -> dict:
    """One param's gradient contributions {pos: f32 slice at the param's
    layout ``held``} -> the whole gradient's slices at the moments' layout
    ``moments`` (a ``PartitionSpec`` that splits the dims ``held`` splits,
    and may split more): a reduce-scatter over each axis the moments add
    (ZeRO-1's "data"), then an all-reduce over each mesh axis neither
    splits (the positions that hold the same slice)."""
    n = len(next(iter(g.values())).shape)
    a, m = _entries(held, n), _entries(moments, n)
    for dim, (ea, em) in enumerate(zip(a, m)):
        if ea != em:
            if ea:
                raise ValueError(f"moments {moments} do not refine the param's {held}")
            for axis in em:
                g = sharding.reduce_scatter(g, mesh, axis, dim)
    used = {x for e in m for x in e}
    for axis in mesh.axis_names:
        if axis not in used:
            g = sharding.all_reduce(g, mesh, axis)
    return g


def _owners(placement, shape) -> set:
    """The positions that own a slice of a leaf laid out by ``placement``:
    the first, row-major, of those that hold each distinct slice."""
    seen, out = set(), set()
    for pos, index in placement.indices_map(tuple(shape)).items():
        key = tuple((s.start, s.stop) for s in index)
        if key not in seen:
            seen.add(key)
            out.add(pos)
    return out


def _sub_view(shard: torch.Tensor, outer: tuple, inner: tuple) -> torch.Tensor:
    """The part of ``shard`` (the slices ``outer`` of a leaf) that is the
    slices ``inner`` of the leaf, as a view."""
    for dim, (o, i) in enumerate(zip(outer, inner)):
        if i.start is not None:
            shard = shard.narrow(dim, i.start - (o.start or 0), i.stop - i.start)
    return shard


def update_partitioned(grads, state: AdamState, params, cfg: TrainConfig, mesh,
                       lr_scale: float = 1.0):
    """``update`` on partitioned leaves: ``params``, ``state.m`` and
    ``state.v`` are trees of ``sharding.Sharded`` (the moments' layout
    refining the params', as ZeRO-1's does), ``grads`` a tree like
    ``params`` whose leaves are {pos: gradient contribution at the param's
    slice}, and ``state.step`` is on the mesh's first entry.  Each gradient
    is reduced into its moments' layout (``reduce_to_moments``, in f32),
    then held in its contributions' dtype, as ``update`` takes a gradient
    in the params' dtype (f32 where the microbatches' sum made it so); the
    contributions are taken out of ``grads`` as each leaf is reduced, so
    that the two are not held whole at once.  The global norm is the sum of
    squares over the distinct slices, each counted at its owner,
    all-reduced over every axis in fixed order; AdamW runs on each
    position's slices, in place; the updated slices are all-gathered back
    into the params' layout.  Returns (params, new state, gnorm on the
    first entry)."""
    g_red, total = [], {pos: None for pos in mesh.positions()}
    for path, m_sh, p_sh in zip(_paths(params), leaves(state.m), leaves(params), strict=True):
        g = grads
        for k in path[:-1]:
            g = g[k]
        g = g.pop(path[-1])
        dtype = next(iter(g.values())).dtype
        r = reduce_to_moments({pos: t.float() for pos, t in g.items()}, p_sh.placement.spec,
                              m_sh.placement.spec, mesh)
        del g
        r = {pos: t.to(dtype) for pos, t in r.items()}
        g_red.append(r)
        owners = _owners(m_sh.placement, m_sh.shape)
        for pos, t in r.items():
            if pos in owners:
                sq = torch.sum(torch.square(t.float()))
                total[pos] = sq if total[pos] is None else total[pos] + sq
    total = {pos: t if t is not None else torch.zeros((), device=mesh.device_at(pos))
             for pos, t in total.items()}
    for axis in mesh.axis_names:
        total = sharding.all_reduce(total, mesh, axis)
    first = next(iter(mesh.positions()))
    step = state.step + 1
    lr = cfg.learning_rate * lr_scale
    factors = {}
    for pos, t in total.items():
        dev = mesh.device_at(pos)
        factors[pos] = _factors(torch.sqrt(t), step.to(dev), cfg)
    with torch.no_grad():
        for r, m_sh, v_sh, p_sh in zip(g_red, leaves(state.m), leaves(state.v), leaves(params),
                                       strict=True):
            outer = p_sh.placement.indices_map(p_sh.shape)
            inner = m_sh.placement.indices_map(m_sh.shape)
            views = {pos: _sub_view(p_sh.shards[pos], outer[pos], inner[pos]) for pos in r}
            for pos in r:
                _apply(r[pos], m_sh.shards[pos], v_sh.shards[pos], views[pos], *factors[pos],
                       lr, cfg)
            whole = sharding.relayout(views, m_sh.placement.spec, p_sh.placement.spec, mesh)
            if whole is not views:
                for pos, t in whole.items():
                    p_sh.shards[pos].copy_(t)
    gnorm = torch.sqrt(total[first])
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
