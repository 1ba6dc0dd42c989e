"""Grouped-query attention, full or sliding-window (PyTorch counterpart of
the GQA half of ``repro/models/attention.py``).

One KV-cache convention for decode::

  GQA cache:  {"k": (B, S_max, KV, hd), "v": (B, S_max, KV, hd)}

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

MLA and cross-attention are not ported yet (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.layers import Leaf, apply_rope, cast, rmsnorm

NEG_INF = -1e9  # bf16-safe large negative

_NOT_PORTED = ("{} is not ported yet: ROADMAP Queue 1 item 6 takes MLA with MoE "
               "and cross-attention with enc-dec (whisper) in later slices")


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
        "wo": Leaf((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = Leaf((hd,), ("head_dim",), init="zeros")
        s["k_norm"] = Leaf((hd,), ("head_dim",), init="zeros")
    return s


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


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=layers.COMPUTE_DTYPE,
                   device=None) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
    }


def _scatter_cache(buf, new, slot):
    """Write new (B,1,KV,hd) into buf (B,S,KV,hd) at each row's slot, in place.

    What the reference's one-hot blend ``buf * (1 - oh) + oh * new`` writes:
    the new row where the slot is in range, the old rows everywhere else
    (a slot out of range writes nothing, as its one-hot row is all zero)."""
    b, s = buf.shape[:2]
    rows = torch.arange(b, device=buf.device)
    in_range = (slot >= 0) & (slot < s)
    idx = slot.clamp(0, s - 1).long()
    old = buf[rows, idx]
    buf[rows, idx] = torch.where(in_range[:, None, None], new[:, 0].to(buf.dtype), old)
    return buf


def decode_bias(cfg: ModelConfig, pos: torch.Tensor, cache_len: int, ring: bool,
                window: Optional[int] = None) -> torch.Tensor:
    """The (B,1,1,1,cache_len) bias of one decode step, the same in every
    layer: a slot is visible where written at or before ``pos`` (a ring
    slot holds the absolute position last written to it; negative: never
    written) and inside the window."""
    b = pos.shape[0]
    j = torch.arange(cache_len, device=pos.device)[None]  # (1, S_max)
    if ring:
        # Absolute position last written to slot j (negative -> never written).
        k_pos = pos[:, None] - torch.remainder(pos[:, None] - j, cache_len)
        valid = k_pos >= 0
    else:
        k_pos = j.expand(b, cache_len)
        valid = k_pos <= pos[:, None]
    return _mask_bias(pos[:, None], k_pos, causal=False, window=window or cfg.sliding_window,
                      k_valid=valid)


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
        # Every stream at the first stream's slot (synchronized positions),
        # the start clamped into the cache as dynamic_update_slice clamps it.
        at = slot[:1].clamp(0, cache_len - 1).long()
        k.index_copy_(1, at, k_new.to(k.dtype))
        v.index_copy_(1, at, v_new.to(v.dtype))
    else:
        _scatter_cache(k, k_new, slot)
        _scatter_cache(v, v_new, slot)

    if bias is None:
        bias = decode_bias(cfg, pos, cache_len, ring, window)
    o = _grouped_attention(q, k.to(x.dtype), v.to(x.dtype), bias)
    return _out(o, p, cfg, x.dtype), {"k": k, "v": v}


# ---------------------------------------------------------------------------
# Not ported yet
# ---------------------------------------------------------------------------


def mla_attention(*args, **kwargs):
    raise NotImplementedError(_NOT_PORTED.format("MLA attention"))


def mla_decode(*args, **kwargs):
    raise NotImplementedError(_NOT_PORTED.format("MLA decode"))


def cross_attention(*args, **kwargs):
    raise NotImplementedError(_NOT_PORTED.format("cross-attention"))
