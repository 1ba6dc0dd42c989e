"""Grouped-query attention (full or sliding-window), DeepSeek-V2's
multi-head latent attention and cross-attention (PyTorch counterpart of
``repro/models/attention.py``).

The KV-cache conventions for decode::

  GQA cache:  {"k": (B, S_max, KV, hd), "v": (B, S_max, KV, hd)}
  MLA cache:  {"ckv": (B, S_max, kv_lora), "k_rope": (B, S_max, rope_dim)}

MLA caches the *compressed* latent (576 values a token at deepseek-v2's
width against 2 * KV * hd) and expands it to per-head K and V at every
step, as the reference does.

Grouped einsums keep K/V un-repeated (no head replication).  The score and
PV products take bf16 operands and accumulate and return f32, as the
reference's ``preferred_element_type=float32`` asks: the operands are
widened to f32 (each bf16 product is exact in f32) and multiplied in f32,
with TF32 off.  Both of the reference's algorithms are here: the naive one
that materializes the (Sq, Sk) scores, and the chunked online-softmax
recurrence over KV chunks (the FlashAttention recurrence, as a loop).

Decode writes its token's K/V into the cache **in place** and returns the
same tensors: a serving loop consumes its cache, as the reference's jitted
loop donates it.  Callers that replay a decode from one prefill clone the
prefill's caches first (``launch.serve._decode_feats`` does).

Cross-attention (whisper's decoder) attends over the encoder's states
with no mask but ``src_valid``; its decode reads K and V that
``models/encdec.py`` projects once from the encoder output.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import layers
from repro_torch.models.layers import Leaf, apply_rope, cast, rmsnorm

NEG_INF = -1e9  # bf16-safe large negative


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


def gqa_schema(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    s = {
        "wq": Leaf((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": Leaf((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Leaf((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Leaf((h, hd, d), ("heads", "head_dim", "embed"), fan_in=h * hd),
    }
    if cfg.qk_norm:
        s["q_norm"] = Leaf((hd,), ("head_dim",), init="zeros")
        s["k_norm"] = Leaf((hd,), ("head_dim",), init="zeros")
    return s


def mla_schema(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_dim
    return {
        "wq_a": Leaf((d, cfg.q_lora_rank), ("embed", None)),
        "q_a_norm": Leaf((cfg.q_lora_rank,), (None,), init="zeros"),
        "wq_b": Leaf(
            (cfg.q_lora_rank, h, qk + cfg.qk_rope_dim), (None, "heads", "head_dim")
        ),
        "wkv_a": Leaf((d, cfg.kv_lora_rank + cfg.qk_rope_dim), ("embed", None)),
        "kv_a_norm": Leaf((cfg.kv_lora_rank,), (None,), init="zeros"),
        "wkv_b": Leaf(
            (cfg.kv_lora_rank, h, qk + cfg.v_head_dim), (None, "heads", "head_dim")
        ),
        "wo": Leaf((h, cfg.v_head_dim, d), ("heads", "head_dim", "embed"),
                   fan_in=h * cfg.v_head_dim),
    }


def cross_schema(cfg: ModelConfig) -> dict:
    d, hd, h = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads
    return {
        "wq": Leaf((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": Leaf((d, h, hd), ("embed", "heads", "head_dim")),
        "wv": Leaf((d, h, hd), ("embed", "heads", "head_dim")),
        "wo": Leaf((h, hd, d), ("heads", "head_dim", "embed"), fan_in=h * hd),
    }


# ---------------------------------------------------------------------------
# Masking and the two attention algorithms
# ---------------------------------------------------------------------------


def _mask_bias(
    q_pos: torch.Tensor,  # (B, Sq)
    k_pos: torch.Tensor,  # (B, Sk)
    causal: bool,
    window: Optional[int],
    k_valid: Optional[torch.Tensor] = None,  # (B, Sk) bool
) -> torch.Tensor:
    """(B, 1, 1, Sq, Sk) additive f32 bias."""
    dq = q_pos[:, :, None]
    dk = k_pos[:, None, :]
    ok = torch.ones(torch.broadcast_shapes(dq.shape, dk.shape), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= dk <= dq
    if window is not None:
        ok &= dq - dk < window
    if k_valid is not None:
        ok &= k_valid[:, None, :]
    return torch.where(ok, 0.0, NEG_INF)[:, None, None, :, :].float()


def _grouped_attention(q, k, v, bias):
    """q: (B,Sq,KV,G,hd); k/v: (B,Sk,KV,hd); bias: (B,1,1,Sq,Sk) -> (B,Sq,KV,G,hd) f32."""
    hd = q.shape[-1]
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())
    scores = scores / math.sqrt(hd) + bias.transpose(1, 2)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs.float(), v.float())


def _chunked_grouped_attention(
    q, k, v, q_pos, k_pos, causal: bool, window: Optional[int], chunk: int
):
    """Flash-style online-softmax attention, looped over KV chunks.

    Never materializes the (Sq, Sk) score matrix: per chunk the working set
    is (B, KV, G, Sq, chunk).  Running max and denominator in f32 (the
    FlashAttention recurrence), step for step the reference's scan body.
    q: (B,Sq,KV,G,hd); k/v: (B,Sk,KV,hd); q_pos/k_pos: (B, Sq)/(B, Sk).
    """
    b, sq, kv, g, hd = q.shape
    sk = k.shape[1]
    chunk = min(chunk, sk)
    if sk % chunk:
        raise ValueError(f"kv len {sk} not divisible by chunk {chunk}")
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    qf = q.float()
    dq = q_pos[:, :, None]

    m = torch.full((b, kv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kv, g, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, chunk):
        k_i, v_i = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        dk = k_pos[:, None, c0:c0 + chunk]
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, k_i.float()) * scale
        ok = torch.ones((b, sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            ok &= dk <= dq
        if window is not None:
            ok &= dq - dk < window
        ok &= dk >= 0  # ring slots never written stay masked
        s = s + torch.where(ok, 0.0, NEG_INF)[:, None, None, :, :]

        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)  # rescale the old accumulator
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bkgqs,bskh->bqkgh", p.to(v_i.dtype).float(), v_i.float())
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    denom = torch.clamp_min(l, 1e-30).permute(0, 3, 1, 2)[..., None]
    return acc / denom


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def _proj(x, w):
    """einsum('bsd,dhe->bshe', x, cast(w)) as one matmul."""
    d, h, e = w.shape
    return (x @ cast(w).reshape(d, h * e)).reshape(x.shape[0], x.shape[1], h, e)


def _qkv(x, p, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    g = cfg.n_heads // kv
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q.reshape(b, s, kv, g, hd), k, v


def _out(o, p, cfg: ModelConfig, dtype):
    """(B,S,KV,G,hd) f32 -> einsum('bshe,hed->bsd', o, cast(wo)) in bf16."""
    b, s = o.shape[:2]
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    return o.reshape(b, s, h * hd).to(dtype) @ cast(p["wo"]).reshape(h * hd, -1)


def gqa_attention(
    x: torch.Tensor,  # (B, S, d) compute dtype
    p: dict,
    cfg: ModelConfig,
    positions: torch.Tensor,  # (B, S)
    causal: bool = True,
    window: Optional[int] = None,
    return_kv: bool = False,
):
    q, k, v = _qkv(x, p, cfg, positions)
    if window is None:
        window = cfg.sliding_window
    if cfg.attention_impl == "chunked":
        o = _chunked_grouped_attention(
            q, k, v, positions, positions, causal, window, cfg.attention_chunk
        )
    else:
        bias = _mask_bias(positions, positions, causal, window)
        o = _grouped_attention(q, k, v, bias)
    out = _out(o, p, cfg, x.dtype)
    if return_kv:
        return out, (k, v)
    return out


def local_heads(cfg: ModelConfig, index: int, n_blocks: int):
    """(q heads [a, b), kv heads [c, e)) of block ``index`` of ``n_blocks``
    of the q heads: q head h attends with kv head h // G (G = H / KV).  A
    block holds whole groups of one or more kv heads, or part of one
    group."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    g, n = h // kv, h // n_blocks
    if n % g and g % n:
        raise ValueError(f"{n} q heads a block do not align with groups of {g}")
    a = index * n
    return (a, a + n), (a // g, (a + n - 1) // g + 1)


def gqa_attention_tp(x: dict, p: dict, cfg: ModelConfig, positions: dict, mesh,
                     heads_split: bool, kv_split: bool) -> dict:
    """``gqa_attention`` per mesh position on its slices, the partial
    outputs reduced over "model".

    ``p`` holds each leaf's slice per position.  With ``heads_split`` a
    position's wq is column-parallel on its block of the q heads and its wo
    row-parallel on the same block; its wk and wv are its block of the kv
    heads (``kv_split``) or whole, and then sliced to the kv heads its q
    heads read (at smoke width, 2 kv heads on a 4-way axis).  Its partial
    output is summed over "model" in axis order.  Without ``heads_split``
    each position attends with every head and nothing is reduced."""
    mi = mesh.axis_names.index("model")
    m = mesh.shape["model"] if heads_split else 1
    out = {}
    for pos, xp in x.items():
        (a, b), (c, e) = local_heads(cfg, pos[mi] if heads_split else 0, m)
        wk, wv = p["wk"][pos], p["wv"][pos]
        if not kv_split:
            wk, wv = wk[:, c:e], wv[:, c:e]
        q, k, v = _proj(xp, p["wq"][pos]), _proj(xp, wk), _proj(xp, wv)
        if cfg.qk_norm:
            q, k = rmsnorm(q, p["q_norm"][pos]), rmsnorm(k, p["k_norm"][pos])
        q = apply_rope(q, positions[pos], cfg.rope_theta)
        k = apply_rope(k, positions[pos], cfg.rope_theta)
        q = q.reshape(q.shape[0], q.shape[1], e - c, (b - a) // (e - c), -1)
        if cfg.attention_impl == "chunked":
            o = _chunked_grouped_attention(q, k, v, positions[pos], positions[pos], True,
                                           cfg.sliding_window, cfg.attention_chunk)
        else:
            o = _grouped_attention(q, k, v, _mask_bias(positions[pos], positions[pos], True,
                                                       cfg.sliding_window))
        wo = p["wo"][pos]
        out[pos] = o.reshape(o.shape[0], o.shape[1], -1).to(xp.dtype) @ cast(wo).reshape(
            -1, wo.shape[-1])
    return sharding.all_reduce(out, mesh, "model") if heads_split else out


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=layers.COMPUTE_DTYPE,
                   device=None) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
    }


def _scatter_cache(buf, new, slot):
    """Write new (B,1,...) into buf (B,S,...) at each row's slot, in place.

    What the reference's one-hot blend ``buf * (1 - oh) + oh * new`` writes:
    the new row where the slot is in range, the old rows everywhere else
    (a slot out of range writes nothing, as its one-hot row is all zero)."""
    b, s = buf.shape[:2]
    rows = torch.arange(b, device=buf.device)
    in_range = (slot >= 0) & (slot < s)
    idx = slot.clamp(0, s - 1).long()
    old = buf[rows, idx]
    keep_new = in_range.view((b,) + (1,) * (old.dim() - 1))
    buf[rows, idx] = torch.where(keep_new, new[:, 0].to(buf.dtype), old)
    return buf


def _write_at_first(buf, new, slot):
    """The ``dus`` write: every stream's new row at the first stream's slot
    (synchronized positions), the start clamped into the cache as
    ``dynamic_update_slice`` clamps it.  An index tensor, never a Python
    int, so a captured graph replays it at each step's slot."""
    at = slot[:1].clamp(0, buf.shape[1] - 1).long()
    buf.index_copy_(1, at, new.to(buf.dtype))


def decode_bias(pos: torch.Tensor, cache_len: int, ring: bool,
                window: Optional[int] = None) -> torch.Tensor:
    """The (B,1,1,1,cache_len) bias of one decode step, the same in every
    layer: a slot is visible where written at or before ``pos`` (a ring
    slot holds the absolute position last written to it; negative: never
    written) and inside ``window`` (None: no window).  The caller decides
    the window: GQA's ``window or cfg.sliding_window``, MLA's none."""
    b = pos.shape[0]
    j = torch.arange(cache_len, device=pos.device)[None]  # (1, S_max)
    if ring:
        # Absolute position last written to slot j (negative -> never written).
        k_pos = pos[:, None] - torch.remainder(pos[:, None] - j, cache_len)
        valid = k_pos >= 0
    else:
        k_pos = j.expand(b, cache_len)
        valid = k_pos <= pos[:, None]
    return _mask_bias(pos[:, None], k_pos, causal=False, window=window, k_valid=valid)


def gqa_decode(
    x: torch.Tensor,  # (B, 1, d)
    p: dict,
    cfg: ModelConfig,
    cache: dict,
    pos: torch.Tensor,  # (B,) ABSOLUTE position (tokens already cached)
    window: Optional[int] = None,
    ring: bool = False,
    bias: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, dict]:
    """One decode step; writes the cache in place and returns it.

    ``ring=True`` treats the cache as a circular buffer of the last
    ``cache_len`` tokens (sliding-window archs): K/V are written at slot
    ``pos % cache_len`` but RoPE always uses absolute positions, and each
    slot's absolute position is reconstructed for masking.  ``bias`` is
    ``decode_bias`` of this step, where the caller made it once for every
    layer."""
    k, v = cache["k"], cache["v"]
    cache_len = k.shape[1]
    q, k_new, v_new = _qkv(x, p, cfg, pos[:, None])  # RoPE at absolute pos
    slot = torch.remainder(pos, cache_len) if ring else pos
    if cfg.cache_update == "dus":
        _write_at_first(k, k_new, slot)
        _write_at_first(v, v_new, slot)
    else:
        _scatter_cache(k, k_new, slot)
        _scatter_cache(v, v_new, slot)

    if bias is None:
        bias = decode_bias(pos, cache_len, ring, window or cfg.sliding_window)
    o = _grouped_attention(q, k.to(x.dtype), v.to(x.dtype), bias)
    return _out(o, p, cfg, x.dtype), {"k": k, "v": v}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def _mla_q(x, p, cfg: ModelConfig, positions):
    q_a = rmsnorm(x @ cast(p["wq_a"]), p["q_a_norm"])
    q = _proj(q_a, p["wq_b"])
    q_nope, q_rope = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_kv(ckv, p, cfg: ModelConfig):
    """Expand the compressed latent (B,S,kv_lora) -> per-head k_nope, v."""
    kv = _proj(ckv, p["wkv_b"])
    return kv.split([cfg.qk_nope_dim, cfg.v_head_dim], dim=-1)


def _mla_latent(x, p, cfg: ModelConfig, positions):
    """The token's cache entries: (ckv (B,S,kv_lora) normed, k_rope
    (B,S,rope_dim) rotated; one rope key shared by every head)."""
    kv_a = x @ cast(p["wkv_a"])
    ckv, k_rope = kv_a.split([cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    ckv = rmsnorm(ckv, p["kv_a_norm"])
    return ckv, apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]


def _mla_scores(q_nope, q_rope, k_nope, k_rope, cfg: ModelConfig, bias):
    """(B,H,Sq,Sk) f32 scores, both products taken in f32 as the
    reference's ``preferred_element_type`` asks; bias (B,1,1,Sq,Sk)."""
    scale = float(1.0 / np.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim))
    scores = (torch.einsum("bqhe,bkhe->bhqk", q_nope.float(), k_nope.float())
              + torch.einsum("bqhe,bke->bhqk", q_rope.float(), k_rope.float()))
    return scores * scale + bias[:, 0]


def _mla_out(o, p, cfg: ModelConfig, dtype):
    """(B,S,H,v_head_dim) -> einsum('bshe,hed->bsd', o, cast(wo)) in bf16."""
    b, s = o.shape[:2]
    return o.reshape(b, s, -1).to(dtype) @ cast(p["wo"]).reshape(-1, cfg.d_model)


def mla_attention(x, p, cfg: ModelConfig, positions, causal: bool = True,
                  return_kv: bool = False):
    q_nope, q_rope = _mla_q(x, p, cfg, positions)
    ckv, k_rope = _mla_latent(x, p, cfg, positions)
    k_nope, v = _mla_kv(ckv, p, cfg)
    bias = _mask_bias(positions, positions, causal, None)
    probs = torch.softmax(_mla_scores(q_nope, q_rope, k_nope, k_rope, cfg, bias), -1)
    o = torch.einsum("bhqk,bkhe->bqhe", probs.to(v.dtype).float(), v.float())
    out = _mla_out(o, p, cfg, x.dtype)
    if return_kv:
        return out, (ckv, k_rope)
    return out


def mla_attention_tp(x: dict, p: dict, cfg: ModelConfig, positions: dict, mesh,
                     heads_split: bool) -> dict:
    """``mla_attention`` per mesh position on its slices, the partial
    outputs reduced over "model".

    ``p`` holds each leaf's slice per position.  With ``heads_split`` a
    position's wq_b and wkv_b are column-parallel on its block of the heads
    and its wo row-parallel on the same block; the down-projections wq_a
    and wkv_a and their norms are whole, so each position computes the
    latent and the one rope key all heads share.  The scores stay f32; the
    partial outputs are summed over "model" in axis order.  Without
    ``heads_split`` each position attends with every head and nothing is
    reduced."""
    out = {pos: mla_attention(xp, {k: v[pos] for k, v in p.items()}, cfg, positions[pos])
           for pos, xp in x.items()}
    return sharding.all_reduce(out, mesh, "model") if heads_split else out


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=layers.COMPUTE_DTYPE,
                   device=None) -> dict:
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype, device=device),
    }


def mla_decode(x, p, cfg: ModelConfig, cache: dict, pos: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, dict]:
    """One decode step; writes the latent cache in place and returns it.
    The whole cache is expanded to per-head K and V every step, as the
    reference does, and masked causally only, whatever ``cfg.sliding_window``
    says (the reference's MLA decode takes no window).  ``bias`` is
    ``decode_bias`` of this step, where the caller made it once for every
    layer."""
    ckv, k_rope = cache["ckv"], cache["k_rope"]
    q_nope, q_rope = _mla_q(x, p, cfg, pos[:, None])
    ckv_new, k_rope_new = _mla_latent(x, p, cfg, pos[:, None])
    if cfg.cache_update == "dus":
        _write_at_first(ckv, ckv_new, pos)
        _write_at_first(k_rope, k_rope_new, pos)
    else:
        _scatter_cache(ckv, ckv_new, pos)
        _scatter_cache(k_rope, k_rope_new, pos)

    k_nope, v = _mla_kv(ckv.to(x.dtype), p, cfg)
    if bias is None:
        bias = decode_bias(pos, ckv.shape[1], ring=False)
    scores = _mla_scores(q_nope, q_rope, k_nope, k_rope.to(x.dtype), cfg, bias)
    probs = torch.softmax(scores, -1).to(x.dtype)
    # A bf16 product in the reference: accumulated in f32, rounded once.
    o = torch.einsum("bhqk,bkhe->bqhe", probs.float(), v.float()).to(x.dtype)
    return _mla_out(o, p, cfg, x.dtype), {"ckv": ckv, "k_rope": k_rope}


# ---------------------------------------------------------------------------
# Cross attention (whisper decoder)
# ---------------------------------------------------------------------------


def cross_attend(x, p, k, v, src_valid=None):
    """x (B,Sq,d) attending over k/v (B,Sk,H,hd), the projected encoder
    states, masked where ``src_valid`` (B,Sk) is False.  Scores in f32,
    divided by sqrt(hd); probabilities in v's dtype; the PV product a bf16
    product in the reference: accumulated in f32, rounded once."""
    q = _proj(x, p["wq"])
    scores = torch.einsum("bqhe,bkhe->bhqk", q.float(), k.to(q.dtype).float())
    scores = scores / math.sqrt(q.shape[-1])
    if src_valid is not None:
        scores = scores + torch.where(src_valid, 0.0, NEG_INF)[:, None, None, :]
    probs = torch.softmax(scores, -1).to(v.dtype)
    o = torch.einsum("bhqk,bkhe->bqhe", probs.float(), v.float()).to(v.dtype)
    b, s = o.shape[:2]
    return o.reshape(b, s, -1).to(x.dtype) @ cast(p["wo"]).reshape(-1, x.shape[-1])


def cross_attention(x, p, ctx, src_valid=None):
    """x: (B, Sq, d) queries; ctx: (B, Sk, d) encoder output."""
    return cross_attend(x, p, _proj(ctx, p["wk"]), _proj(ctx, p["wv"]), src_valid)
