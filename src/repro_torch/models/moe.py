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

``moe_impl="ep"`` runs the explicit expert-parallel block only under a mesh
with a ``"model"`` axis, as the reference does; the port's only mesh
(``distributed.sharding.FleetMesh``) has none, so it always runs the dense
block.  The EP block itself is ROADMAP Queue 1 item 6.5, with the
model-axis mesh it needs.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models.layers import Leaf
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
        raise NotImplementedError(
            "moe_block_ep needs a mesh with a 'model' axis; ROADMAP Queue 1 item 6.5 "
            "ports it with make_dev_mesh")
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


def _moe_block_dense(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """Scatter-dispatch top-k MoE (the reference's baseline block)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cfg, t)
    xt = x.reshape(t, d)

    _, gate_k, idx_k, aux = route(xt, p["router"], cfg)
    flat_e, pos, keep = dispatch_slots(idx_k, e, cap)

    # Dispatch: row e * cap + slot of an (E cap + 1, d) buffer; every
    # dropped pair writes the trash row E cap, which no expert reads.
    rows = torch.where(keep, flat_e * cap + pos, e * cap)
    buf = x.new_zeros((e * cap + 1, d))
    buf.index_copy_(0, rows, xt[:, None].expand(t, k, d).reshape(t * k, d))
    buf = buf[: e * cap].view(e, cap, d)

    # The experts: batched products over the expert axis.
    h = _silu(_dot(buf, p["wg"])) * _dot(buf, p["wu"])
    out_e = _dot(h, p["wd"]).view(e * cap, -1)

    # Combine: each pair's expert row (zero where dropped) times its gate,
    # added per token in choice order.
    gathered = out_e[flat_e * cap + torch.clamp_max(pos, cap - 1)]
    gathered = torch.where(keep[:, None], gathered, 0)
    w = gate_k.reshape(-1)[:, None].to(x.dtype)
    contrib = (gathered * w).view(t, k, -1)
    y = torch.zeros_like(contrib[:, 0])
    for j in range(k):
        y = y + contrib[:, j]

    # Shared experts: the always-on dense path.
    if "shared" in p:
        sh = p["shared"]
        y = y + _dot(_silu(_dot(xt, sh["wg"])) * _dot(xt, sh["wu"]), sh["wd"])
    return y.view(b, s, d), aux
