"""Fine-grained MoE (DeepSeekMoE): shared experts + routed top-k experts
(PyTorch counterpart of ``repro/models/moe.py``).

Dispatch is scatter-based into capacity-bounded buffers, so the expert
products' FLOPs match the *active* parameter count (capacity slots =
top_k * tokens * capacity_factor).  The router is a softmax over all
experts, top-k selection, the selected gates renormalized (DeepSeek's
gating), plus the load-balancing auxiliary loss (Switch/GShard form).

Every step is the reference's, in its dtypes:

- the router's logits, softmax and top-k in f32; ties between equal
  probabilities go to the lower expert index, as ``jax.lax.top_k`` breaks
  them (a stable descending sort; ``torch.topk`` promises no order);
- each (token, choice) pair's slot in its expert is the exclusive cumsum of
  the choices before it in token-major order; a pair whose slot is past the
  capacity is dropped.  The reference adds a dropped pair's zero row at the
  last slot; here it goes to one trash row past every expert's slots, so
  each kept row is written once (unique indices: no atomics, the same bits
  on every run) and the trash row is never read;
- silu as the reference computes it, one rounding per step;
- the combine adds each token's k weighted expert rows in choice order, one
  bf16 rounding per add, as the reference's scatter-add does (no
  ``index_add_``: its atomics would add in any order).

The capacity is a Python int of the shapes, and nothing here reads a value
back to the host, so a decode step with MoE layers captures as one CUDA
graph.

``moe_impl="ep"`` runs the explicit expert-parallel block
(``moe_block_ep``) under a mesh with a ``"model"`` axis, as the reference
does: each token shard routes and dispatches its own tokens, an exchange
over ``"model"`` sends every expert's capacity buffers to the mesh entry
that holds the expert, the expert products run there on the local experts'
weights, and the reverse exchange brings the rows back for the combine.
The exchanges are explicit tensor moves between mesh entries
(``distributed.sharding``).  Without such a mesh it runs the dense block.

``moe_block_tp`` is the block of the partitioned training step
(``model.partitioned_train_step``): the same phases between the positions
of each model row, on the positions' own slices of the expert weights, with
either ``moe_impl``'s capacity (the dense block's one over the whole batch,
or one per token shard).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models.layers import Leaf, model_split, swiglu_tp
from repro_torch.models.layers import dot as _dot
from repro_torch.models.layers import silu as _silu


def moe_schema(cfg: ModelConfig) -> dict:
    d, fe = cfg.d_model, cfg.d_ff_expert
    e = cfg.n_experts
    s = {
        "router": Leaf((d, e), ("embed", "experts"), scale=0.02),
        "wg": Leaf((e, d, fe), ("experts", "embed", "mlp")),
        "wu": Leaf((e, d, fe), ("experts", "embed", "mlp")),
        "wd": Leaf((e, fe, d), ("experts", "mlp", "embed")),
    }
    if cfg.n_shared_experts:
        fs = cfg.d_ff_expert * cfg.n_shared_experts
        s["shared"] = {
            "wg": Leaf((d, fs), ("embed", "mlp")),
            "wu": Leaf((d, fs), ("embed", "mlp")),
            "wd": Leaf((fs, d), ("mlp", "embed")),
        }
    return s


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(cfg.top_k * n_tokens * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8, as the reference aligns lanes


def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """x: (B, S, d) -> (y, aux_loss).  Dispatches on cfg.moe_impl."""
    mesh = sharding.mesh_or_none()
    if cfg.moe_impl == "ep" and mesh is not None and "model" in mesh.axis_names:
        return moe_block_ep(x, p, cfg, mesh)
    return _moe_block_dense(x, p, cfg)


def route(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """The router of T tokens: (probs (T, E) f32, gates (T, k) f32
    renormalized, expert indices (T, k), aux loss (0-d f32))."""
    e, k = cfg.n_experts, cfg.top_k
    logits = xt.float() @ router.float()  # (T, E)
    probs = torch.softmax(logits, -1)
    # Ties to the lower index, as jax.lax.top_k: a stable descending sort.
    gate_k, idx_k = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_k, idx_k = gate_k[:, :k], idx_k[:, :k]
    gate_k = gate_k / torch.clamp_min(gate_k.sum(-1, keepdim=True), 1e-9)
    # Load-balancing aux loss: mean prob * mean assignment per expert.
    me = torch.mean(probs, 0)
    counts = (idx_k[..., None] == torch.arange(e, device=xt.device)).sum((0, 1))
    ce = counts.float() / xt.shape[0]
    aux = e * torch.sum(me * ce)
    return probs, gate_k, idx_k, aux


def dispatch_slots(idx_k: torch.Tensor, n_experts: int, cap: int):
    """(flat expert index (T k,), slot within the expert (T k,), kept
    (T k,) bool): each (token, choice) pair's slot is the number of pairs
    before it, token-major, that chose the same expert."""
    flat_e = idx_k.reshape(-1)
    experts = torch.arange(n_experts, device=idx_k.device)
    # Expert-major (E, T k), so the scan runs along the inner dim: on an
    # H100 torch's scan along the outer dim of (T k, E) took 7.5 ms of a
    # 42 ms deepseek-moe-16b decode step (28 layers, B=256).
    onehot = (experts[:, None] == flat_e).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, 1, dtype=torch.int32) - onehot  # exclusive
    pos = torch.gather(pos_in_e, 0, flat_e[None])[0]
    return flat_e, pos, pos < cap


def _dispatch(xt: torch.Tensor, flat_e, pos, keep, n_experts: int, cap: int):
    """The (E, cap, d) capacity buffers of T tokens: pair (t, j) at row
    ``flat_e * cap + pos`` of an (E cap + 1, d) buffer; every dropped pair
    writes the trash row E cap, which is sliced away (so a dropped pair's
    input gradient is exactly 0)."""
    t, d = xt.shape
    k = flat_e.shape[0] // t
    rows = torch.where(keep, flat_e * cap + pos, n_experts * cap)
    buf = xt.new_zeros((n_experts * cap + 1, d))
    buf.index_copy_(0, rows, xt[:, None].expand(t, k, d).reshape(t * k, d))
    return buf[: n_experts * cap].view(n_experts, cap, d)


def _experts(buf: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """Batched products over the expert axis: (E', C, d) -> (E', C, d)."""
    return _dot(_silu(_dot(buf, wg)) * _dot(buf, wu), wd)


def _combine(out_e: torch.Tensor, flat_e, pos, keep, gate_k, dtype) -> torch.Tensor:
    """Each pair's expert row (zero where dropped) times its gate, added
    per token in choice order: (T, d)."""
    e, cap, d = out_e.shape
    t, k = gate_k.shape
    gathered = out_e.reshape(e * cap, d)[flat_e * cap + torch.clamp_max(pos, cap - 1)]
    gathered = torch.where(keep[:, None], gathered, 0)
    contrib = (gathered * gate_k.reshape(-1)[:, None].to(dtype)).view(t, k, d)
    y = torch.zeros_like(contrib[:, 0])
    for j in range(k):
        y = y + contrib[:, j]
    return y


def _shared_mlp(x: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """The shared experts' gated MLP, in the reference's steps."""
    return _dot(_silu(_dot(x, wg)) * _dot(x, wu), wd)


def _shared(xt: torch.Tensor, sh: dict) -> torch.Tensor:
    """The shared experts: the always-on dense path."""
    return _shared_mlp(xt, sh["wg"], sh["wu"], sh["wd"])


def _moe_block_dense(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """Scatter-dispatch top-k MoE (the reference's baseline block)."""
    b, s, d = x.shape
    t = b * s
    e = cfg.n_experts
    cap = _capacity(cfg, t)
    xt = x.reshape(t, d)
    _, gate_k, idx_k, aux = route(xt, p["router"], cfg)
    flat_e, pos, keep = dispatch_slots(idx_k, e, cap)
    out_e = _experts(_dispatch(xt, flat_e, pos, keep, e, cap), p["wg"], p["wu"], p["wd"])
    y = _combine(out_e, flat_e, pos, keep, gate_k, x.dtype)
    if "shared" in p:
        y = y + _shared(xt, p["shared"])
    return y.view(b, s, d), aux


# ---------------------------------------------------------------------------
# Explicit expert parallelism: phases with the exchanges between them
# ---------------------------------------------------------------------------
#
# The reference's ``moe_block_ep`` is one function under ``shard_map`` with
# two all-to-alls over "model" inside it.  One process calls the mesh's
# positions one after another, so here the function is cut at the
# exchanges: (1) every position routes and dispatches its token shard into
# (E, C_loc, d) buffers; (2) position (.., j) gathers the [j E/m, (j+1) E/m)
# experts' buffers of every position of its model row, concatenated along
# capacity in model order: (E/m, m C_loc, d); (3) the expert products on its
# local experts' weights; (4) the reverse exchange: position (.., j) gathers
# capacity block j of every model-row position's output, concatenated along
# the experts in model order: (E, C_loc, d); (5) the combine.  An exchange
# is a tensor moved to the receiving position's entry by
# ``sharding.exchange`` (no copy where two entries name one device; an
# ``all-to-all`` in a census), so autograd runs through it.


def ep_layout(n_tokens: int, cfg: ModelConfig, mesh: sharding.Mesh):
    """The EP block's split of ``n_tokens`` tokens on ``mesh``, as the
    reference's: ``(token axes, token shards, tokens a shard, capacity a
    shard)``.  Tokens split over every data axis and "model" (so the m
    model positions of a data row do not dispatch the same tokens), with
    axes dropped from the right until the split divides; None where none
    does (the block then runs dense)."""
    tok_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names) + ("model",)
    while tok_axes:
        n_split = math.prod(mesh.shape[a] for a in tok_axes)
        if n_tokens % n_split == 0:
            t_loc = n_tokens // n_split
            return tok_axes, n_split, t_loc, _capacity(cfg, t_loc)
        tok_axes = tok_axes[:-1]
    return None


def _token_shard(pos: tuple, tok_axes: tuple, mesh: sharding.Mesh) -> int:
    """The token shard mesh position ``pos`` holds: its coordinates along
    the token axes, row-major (positions that differ on other axes hold the
    same shard)."""
    coord = dict(zip(mesh.axis_names, pos))
    k = 0
    for a in tok_axes:
        k = k * mesh.shape[a] + coord[a]
    return k


def _shard_homes(tok_axes: tuple, mesh: sharding.Mesh) -> dict:
    """{token shard: the first position, row-major, that holds it}."""
    homes = {}
    for pos in mesh.positions():
        homes.setdefault(_token_shard(pos, tok_axes, mesh), pos)
    return homes


def _to_homes(bufs: dict, mesh: sharding.Mesh, e_loc: int) -> dict:
    """Phase (2), the dispatch exchange: position (.., j) takes experts
    [j e_loc, (j+1) e_loc) of the (E, C, d) buffers of every position of its
    model row, concatenated along the capacity in model order: {pos:
    (e_loc, m C, d)}."""
    mi = mesh.axis_names.index("model")
    out = {}
    for pos in bufs:
        experts = slice(pos[mi] * e_loc, (pos[mi] + 1) * e_loc)
        out[pos] = torch.cat([sharding.exchange(bufs[q][experts], q, pos, mesh)
                              for q in sharding.peers(pos, mesh, "model")], dim=1)
    return out


def _from_homes(out: dict, mesh: sharding.Mesh, cap: int, at) -> dict:
    """Phase (4), the return exchange, at the positions ``at``: position
    (.., j) takes capacity block j of the (e_loc, m C, d) outputs of every
    position of its model row, concatenated along the experts in model
    order: {pos: (E, C, d)}."""
    mi = mesh.axis_names.index("model")
    block = {pos: slice(pos[mi] * cap, (pos[mi] + 1) * cap) for pos in at}
    return {pos: torch.cat([sharding.exchange(out[q][:, block[pos]], q, pos, mesh)
                            for q in sharding.peers(pos, mesh, "model")], dim=0)
            for pos in at}


def moe_block_ep(x: torch.Tensor, p: dict, cfg: ModelConfig, mesh: sharding.Mesh):
    """x: (B, S, d) -> (y, aux): the reference's EP block on ``mesh``, each
    position's work on its entry; y and aux on x's device.  aux is the mean
    of the token shards' aux losses (the reference's pmean over the token
    axes); the shared experts run on all tokens."""
    b, s, d = x.shape
    e = cfg.n_experts
    m = mesh.shape["model"]
    if e % m:
        raise ValueError(f"{e} experts do not split over a model axis of {m}")
    layout = ep_layout(b * s, cfg, mesh)
    if layout is None:
        return _moe_block_dense(x, p, cfg)
    tok_axes, n_split, t_loc, cap = layout
    e_loc = e // m
    mi = mesh.axis_names.index("model")
    xt = x.reshape(b * s, d)
    positions = list(mesh.positions())

    # (1) route and dispatch each position's token shard.
    routing, bufs, auxes = {}, {}, {}
    for pos in positions:
        dev = mesh.device_at(pos)
        k = _token_shard(pos, tok_axes, mesh)
        xs = xt[k * t_loc:(k + 1) * t_loc].to(dev)
        _, gate_k, idx_k, auxes[pos] = route(xs, p["router"].to(dev), cfg)
        flat_e, slot, keep = dispatch_slots(idx_k, e, cap)
        routing[pos] = (flat_e, slot, keep, gate_k)
        bufs[pos] = _dispatch(xs, flat_e, slot, keep, e, cap)
    # (2) dispatch exchange and (3) the local experts' products.
    recv = _to_homes(bufs, mesh, e_loc)
    out = {}
    for pos in positions:
        experts = slice(pos[mi] * e_loc, (pos[mi] + 1) * e_loc)
        dev = mesh.device_at(pos)
        out[pos] = _experts(recv[pos], *(p[w][experts].to(dev) for w in ("wg", "wu", "wd")))
    # (4) return exchange and (5) the combine, at one position per token shard.
    homes = _shard_homes(tok_axes, mesh)
    back = _from_homes(out, mesh, cap, homes.values())
    ys = {k: _combine(back[pos], *routing[pos], x.dtype).to(x.device) for k, pos in homes.items()}
    y = torch.cat([ys[k] for k in range(n_split)])
    aux = torch.stack([auxes[homes[k]].to(x.device) for k in range(n_split)]).mean()
    if "shared" in p:
        y = y + _shared(xt, p["shared"])
    return y.view(b, s, d), aux


# ---------------------------------------------------------------------------
# The MoE block of the partitioned training step
# ---------------------------------------------------------------------------
#
# In ``model.partitioned_train_step`` every position of a data row holds the
# row's residual stream, and the block's leaves are the position's slices:
# the router whole, the expert weights the position's block of E/m experts.
# Each position routes its token shard (``ep_layout``: the row's tokens
# split further over "model" where they divide), the phases of the EP block
# above run between the positions of each model row, and the row's y is
# all-gathered over "model" so that every position of the row holds it
# whole again.  The capacity follows ``cfg.moe_impl``:
#
# * "ep": a capacity per token shard, and the aux the mean of the shards'
#   aux losses, as ``moe_block_ep`` computes them;
# * "dense": the dense block's one capacity over the whole batch, with the
#   slots in its global token order: each shard sends its per-expert pair
#   counts to every other shard (E int32 each), and a pair's slot is the
#   pairs the shards before it (row-major) sent to its expert plus its
#   exclusive cumsum in its own shard.  A shard fills at most min(T_loc,
#   capacity) slots of an expert, so its buffers have that many rows, and
#   expert block j runs at position (i, j) on the slots data row i's tokens
#   fill: every kept pair's product is the dense block's, and no position
#   computes another row's slots.  The aux is the dense block's over every
#   token, e sum(mean probs mean counts): each shard's share of the sum
#   (its probs' sum against the batch's counts), summed.
#
# The reductions over "model" (the y all-gather, the shared experts'
# partial products' all-reduce) and the aux's gather come after the last
# tensor the backward needs, so that remat's recompute stops before them.


def moe_block_tp(h: dict, w: dict, cfg: ModelConfig, mesh: sharding.Mesh, layout: dict):
    """The MoE block on the (data, model) ``mesh`` of the partitioned
    training step: h {pos: (B_loc, S, d)}, the same at every position of a
    data row, -> ({pos: y (B_loc, S, d)}, aux, a 0-d f32 tensor on the
    mesh's first entry).  ``w`` holds the block's leaves {name in the block:
    {pos: tensor}} in their compute layout, ``layout`` their (held spec,
    compute spec): the router whole, ``wg``/``wu``/``wd`` the position's
    block of the experts, the shared experts column- and row-parallel on
    their d_ff where ``layout["shared/wd"]`` splits it (``layers.swiglu_tp``)."""
    e = cfg.n_experts
    m, n_rows = mesh.shape["model"], mesh.shape["data"]
    if e % m:
        raise ValueError(f"{e} experts do not split over a model axis of {m}")
    b_loc, s, d = next(iter(h.values())).shape
    t_row = b_loc * s
    t_all = t_row * n_rows
    tok_axes, n_split, t_loc, cap = ep_layout(t_all, cfg, mesh)
    dense = cfg.moe_impl == "dense"
    if dense:
        cap = _capacity(cfg, t_all)
    rows = min(t_loc, cap) if dense else cap  # a shard's buffer rows an expert
    per_row = n_split // n_rows
    xt = {pos: x.reshape(t_row, d) for pos, x in h.items()}
    positions = list(h)
    shard = {pos: _token_shard(pos, tok_axes, mesh) for pos in positions}
    homes = _shard_homes(tok_axes, mesh)
    first = positions[0]

    # The shared experts' partial products, reduced at the end.
    split = "shared/wd" in w and model_split(layout["shared/wd"][1], 0)
    shared = None if "shared/wd" not in w else swiglu_tp(
        xt, w["shared/wg"], w["shared/wu"], w["shared/wd"], mesh, split=False, fn=_shared_mlp)
    # (1) route each position's token shard and place its pairs.
    xs, routed, slots = {}, {}, {}
    for pos in positions:
        k = shard[pos] % per_row
        xs[pos] = xt[pos][k * t_loc:(k + 1) * t_loc]
        routed[pos] = route(xs[pos], w["router"][pos], cfg)
        slots[pos] = dispatch_slots(routed[pos][2], e, rows)
    auxes = {pos: r[3] for pos, r in routed.items()}
    if dense:
        experts = torch.arange(e, device=h[first].device)
        counts = {pos: (r[2][..., None] == experts.to(r[2].device)).sum((0, 1), dtype=torch.int32)
                  for pos, r in routed.items()}
        for pos in positions:
            got = {kk: counts[pos] if kk == shard[pos] else
                   sharding.exchange(counts[q], q, pos, mesh, "all-gather")
                   for kk, q in homes.items()}
            before = sum((got[kk] for kk in range(shard[pos])), torch.zeros_like(counts[pos]))
            total = sum((got[kk] for kk in range(n_split)), torch.zeros_like(counts[pos]))
            flat_e, slot, _ = slots[pos]
            slots[pos] = (flat_e, slot, before[flat_e] + slot < cap)
            probs = routed[pos][0]
            auxes[pos] = e * torch.sum(probs.sum(0) / t_all * (total.float() / t_all))
    # (2) dispatch, the exchange to the experts' homes, (3) the local
    # experts' products, (4) the return exchange and (5) the combine.
    bufs = {pos: _dispatch(xs[pos], *slots[pos], e, rows) for pos in positions}
    recv = _to_homes(bufs, mesh, e // m)
    out = {pos: _experts(recv[pos], w["wg"][pos], w["wu"][pos], w["wd"][pos])
           for pos in positions}
    back = _from_homes(out, mesh, rows, positions)
    y = {pos: _combine(back[pos], *slots[pos], routed[pos][1], h[pos].dtype)
         for pos in positions}
    # The row's y whole at each of its positions, the shared experts'
    # partial products summed, the shards' aux on the first entry.
    if "model" in tok_axes:
        y = sharding.all_gather(y, mesh, "model", 0)
    if split:
        shared = sharding.all_reduce(shared, mesh, "model")
    parts = torch.stack([sharding.exchange(auxes[q], q, first, mesh, "gather")
                         for q in homes.values()])
    aux = parts.sum() if dense else parts.mean()
    if shared is not None:
        y = {pos: t + shared[pos] for pos, t in y.items()}
    return {pos: t.view(b_loc, s, d) for pos, t in y.items()}, aux
