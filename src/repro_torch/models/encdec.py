"""Whisper-style encoder-decoder backbone, audio frontend stubbed (PyTorch
counterpart of ``repro/models/encdec.py``).

The conv frontend is a stub: callers supply precomputed frame embeddings
(B, T_frames, d_model), and a learned adapter linear stands in for the conv
stack's output projection.  Sinusoidal positions on the encoder, learned
positions on the decoder (as in Whisper), and RoPE inside every
self-attention as well, as the reference's ``_qkv`` applies it.

Decode caches: per decoder layer a self-attention K/V cache, written in
place by ``decode_step`` as ``attention.gqa_decode`` writes it, and the
cross-attention K/V computed once at prefill from the encoder output
(cross K/V do not depend on the position, Whisper's serving trick).

Layers keep the reference's stacked layout (``enc_layers`` and
``dec_layers``, a leading L dim on every leaf) and run as a loop over that
dim (``transformer.run_layers``); while autograd records, each layer is
recomputed in the backward pass instead of keeping its activations, as in
``transformer.lm_hidden``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention
from repro_torch.models.layers import (
    Leaf,
    cast,
    dot,
    gelu_mlp,
    layernorm,
    sinusoidal_embedding,
    stack_schema,
)
from repro_torch.models.transformer import _layer, _positions, run_layers


def _ln(d):
    return {"w": Leaf((d,), ("embed",), init="ones"), "b": Leaf((d,), ("embed",), init="zeros")}


def _mlp(d, ff):
    return {"wi": Leaf((d, ff), ("embed", "mlp")), "wo": Leaf((ff, d), ("mlp", "embed"))}


def _enc_layer_schema(cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "ln1": _ln(d),
        "attn": attention.gqa_schema(cfg),
        "ln2": _ln(d),
        "mlp": _mlp(d, ff),
    }


def _dec_layer_schema(cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "ln1": _ln(d),
        "self": attention.gqa_schema(cfg),
        "ln2": _ln(d),
        "cross": attention.cross_schema(cfg),
        "ln3": _ln(d),
        "mlp": _mlp(d, ff),
    }


def encdec_schema(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "adapter": Leaf((d, d), ("embed", None)),  # stands for the conv stem out-proj
        "enc_layers": stack_schema(_enc_layer_schema(cfg), cfg.n_enc_layers),
        "enc_norm": _ln(d),
        "embed": Leaf((cfg.vocab_size, d), ("vocab", "embed"), init="embed"),
        "dec_pos": Leaf((cfg.max_source_len, d), (None, "embed"), init="embed", scale=0.02),
        "dec_layers": stack_schema(_dec_layer_schema(cfg), cfg.n_layers),
        "dec_norm": _ln(d),
    }


def _norm(h, p):
    return layernorm(h, p["w"], p["b"])


def _stack(stacked, depth, layer):
    """(layer, layer i's params) for each of the ``depth`` layers."""
    return [(layer, _layer(stacked, i)) for i in range(depth)]


def _enc_layer(h, lp, cfg: ModelConfig, positions):
    h = h + attention.gqa_attention(_norm(h, lp["ln1"]), lp["attn"], cfg, positions,
                                    causal=False)
    hn = _norm(h, lp["ln2"])
    return h + gelu_mlp(hn, lp["mlp"]["wi"], lp["mlp"]["wo"]), 0.0


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig, remat: bool = True):
    """frames: (B, T, d) stubbed frame embeddings -> encoder states (B, T, d)
    in bf16.  The frames are rounded to bf16 for the adapter product, as
    the reference rounds them."""
    t = frames.shape[1]
    h = dot(frames.to(torch.bfloat16), params["adapter"])
    h = h + sinusoidal_embedding(t, cfg.d_model, frames.device)[None].to(h.dtype)
    positions = _positions(frames[:, :, 0])  # (B, T) frame indices
    h, _ = run_layers(h, _stack(params["enc_layers"], cfg.n_enc_layers, _enc_layer), remat, cfg,
                      positions)
    return _norm(h, params["enc_norm"])


def _dec_layer(h, lp, cfg: ModelConfig, positions, enc):
    h = h + attention.gqa_attention(_norm(h, lp["ln1"]), lp["self"], cfg, positions,
                                    causal=True)
    h = h + attention.cross_attention(_norm(h, lp["ln2"]), lp["cross"], enc)
    hn = _norm(h, lp["ln3"])
    return h + gelu_mlp(hn, lp["mlp"]["wi"], lp["mlp"]["wo"]), 0.0


def decode_train(params: dict, tokens: torch.Tensor, enc: torch.Tensor, cfg: ModelConfig,
                 remat: bool = True):
    """Teacher-forced decoder -> final hidden (B, S, d) in bf16."""
    s = tokens.shape[1]
    h = cast(params["embed"])[tokens.long()] + cast(params["dec_pos"])[None, :s]
    h, _ = run_layers(h, _stack(params["dec_layers"], cfg.n_layers, _dec_layer), remat, cfg,
                      _positions(tokens), enc)
    return _norm(h, params["dec_norm"])


def logits(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    return hidden @ cast(params["embed"]).t()  # tied head


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------


def init_caches(params: dict, enc: torch.Tensor, cfg: ModelConfig, max_len: int) -> dict:
    """Self-attention caches (zeros, bf16, ``max_len`` slots) and the cross
    K/V precomputed from the encoder states, (L, B, T, H, hd) each, on
    ``enc``'s device."""
    b, t, _ = enc.shape
    hd = cfg.resolved_head_dim
    ck = enc.new_empty((cfg.n_layers, b, t, cfg.n_heads, hd))
    cv = torch.empty_like(ck)
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], i)["cross"]
        ck[i] = attention._proj(enc, lp["wk"])
        cv[i] = attention._proj(enc, lp["wv"])
    one = attention.gqa_init_cache(cfg, b, max_len, device=enc.device)
    self_cache = {k: a.new_zeros((cfg.n_layers,) + a.shape) for k, a in one.items()}
    return {"self": self_cache, "cross_k": ck, "cross_v": cv}


def _cross_from_cache(x, p, ck, cv):
    return attention.cross_attend(x, p, ck, cv.to(x.dtype))


def decode_step(params: dict, token: torch.Tensor, caches: dict, pos: torch.Tensor,
                cfg: ModelConfig):
    """One decoder token (B, 1) at positions ``pos`` (B,) -> final hidden
    (B, 1, d) and the caches, the self-attention K/V written in place (the
    same tensors come back); cross-attention reads the precomputed K/V."""
    h = cast(params["embed"])[token.long()] + cast(params["dec_pos"])[pos.long()][:, None]
    self_cache = caches["self"]
    bias = attention.decode_bias(pos, self_cache["k"].shape[2], ring=False,
                                 window=cfg.sliding_window)
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], i)
        a, _ = attention.gqa_decode(_norm(h, lp["ln1"]), lp["self"], cfg,
                                    _layer(self_cache, i), pos, bias=bias)
        h = h + a
        h = h + _cross_from_cache(_norm(h, lp["ln2"]), lp["cross"], caches["cross_k"][i],
                                  caches["cross_v"][i])
        hn = _norm(h, lp["ln3"])
        h = h + gelu_mlp(hn, lp["mlp"]["wi"], lp["mlp"]["wo"])
    return _norm(h, params["dec_norm"]), caches
