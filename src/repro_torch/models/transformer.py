"""Decoder-only LM assembly, the dense and MoE paths (PyTorch counterpart
of ``repro/models/transformer.py``).

One code path serves the seven decoder-only archs of two families:

  dense — GQA attention (+ optional sliding window / qk_norm) + SwiGLU:
          h2o-danube-1.8b, deepseek-coder-33b, mistral-nemo-12b, qwen3-4b
          and chameleon-34b (a dense stack behind a frontend stub);
  moe   — GQA or MLA attention + fine-grained MoE: deepseek-moe-16b,
          deepseek-v2-236b (every layer MoE, as the reference's configs).

Layers keep the reference's stacked layout (a leading L dim on every layer
leaf, so a converted param tree is a plain copy) and run as a loop over
that dim; caches keep the reference's structure too (``{"layers": {"k":
(L, B, S, KV, hd), "v": ...}}``, or ``{"layers": {"ckv": (L, B, S,
kv_lora), "k_rope": ...}}`` with MLA).  ``lm_hidden`` is the training
forward too, with the reference's remat, and sums the MoE layers' aux loss
in layer order as the reference's scan carry does.

The SSD scan, hybrid RG-LRU stacks and the encoder-decoder raise
``NotImplementedError``: ROADMAP Queue 1 item 6 ports them in later slices.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, moe
from repro_torch.models.layers import Leaf, cast, rmsnorm, stack_schema, swiglu


def require_dense(cfg: ModelConfig) -> None:
    """Raise for the families the port has no backbone for yet (dense and
    MoE stacks, GQA or MLA, have one)."""
    missing = None
    if cfg.enc_dec:
        missing = "the encoder-decoder (whisper)"
    elif cfg.family == "ssm":
        missing = "the SSD scan (mamba2)"
    elif cfg.hybrid_pattern:
        missing = "the hybrid RG-LRU stack (recurrentgemma)"
    if missing is not None:
        raise NotImplementedError(
            f"{cfg.arch_id}: {missing} is not ported yet; ROADMAP Queue 1 item 6 "
            "lists it after the dense and MoE serving paths")


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------


def _mixer_schema(cfg: ModelConfig) -> dict:
    require_dense(cfg)
    d, ff = cfg.d_model, cfg.d_ff
    s: dict = {"ln1": Leaf((d,), ("embed",), init="zeros")}
    s["attn"] = attention.mla_schema(cfg) if cfg.use_mla else attention.gqa_schema(cfg)
    s["ln2"] = Leaf((d,), ("embed",), init="zeros")
    if cfg.n_experts:
        s["moe"] = moe.moe_schema(cfg)
    else:
        s["mlp"] = {
            "wg": Leaf((d, ff), ("embed", "mlp")),
            "wu": Leaf((d, ff), ("embed", "mlp")),
            "wd": Leaf((ff, d), ("mlp", "embed")),
        }
    return s


def lm_schema(cfg: ModelConfig) -> dict:
    require_dense(cfg)
    s: dict = {
        "embed": Leaf((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), init="embed"),
        "final_norm": Leaf((cfg.d_model,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = Leaf((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    s["layers"] = stack_schema(_mixer_schema(cfg), cfg.n_layers)
    return s


def _layer(stacked: dict, i: int) -> dict:
    """Layer i's params: a view of every stacked leaf at index i."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return cast(params["embed"])[tokens.long()]


# ---------------------------------------------------------------------------
# Forward (prefill without caches)
# ---------------------------------------------------------------------------


def _ffn(h, lp, cfg: ModelConfig):
    """The layer's second half: (h + MoE or SwiGLU of its norm, aux loss)."""
    hn = rmsnorm(h, lp["ln2"])
    if cfg.n_experts:
        y, aux = moe.moe_block(hn, lp["moe"], cfg)
        return h + y, aux
    return h + swiglu(hn, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"]), 0.0


def _dense_layer(h, lp, cfg: ModelConfig, positions):
    hn = rmsnorm(h, lp["ln1"])
    attend = attention.mla_attention if cfg.use_mla else attention.gqa_attention
    return _ffn(h + attend(hn, lp["attn"], cfg, positions), lp, cfg)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)


def lm_hidden(
    params: dict,
    tokens: torch.Tensor,  # (B, S) int
    cfg: ModelConfig,
    positions: Optional[torch.Tensor] = None,
    remat: bool = True,
    layer_params: Optional[list] = None,
) -> tuple[torch.Tensor, torch.Tensor | float]:
    """Token ids -> final hidden states (B, S, d) [compute dtype], aux loss
    (the MoE layers' sum, a 0-d f32 tensor; 0.0 for a dense stack).

    ``layer_params`` holds each layer's params; by default they are views of
    the stacked leaves at each index.  A training step passes views of its
    own, whose gradients it gathers (``model.loss_and_grads``).

    ``remat`` recomputes each layer in the backward pass instead of keeping
    its activations (``torch.utils.checkpoint``, the counterpart of the
    reference's ``jax.checkpoint`` with ``nothing_saveable``): it applies
    only where autograd records the stack, so serving runs as it did."""
    require_dense(cfg)
    if positions is None:
        positions = _positions(tokens)
    if layer_params is None:
        layer_params = [_layer(params["layers"], i) for i in range(cfg.n_layers)]
    h = _embed(params, tokens)
    recompute = remat and torch.is_grad_enabled() and h.requires_grad
    aux = 0.0
    for lp in layer_params:
        if recompute:
            h, a = checkpoint(_dense_layer, h, lp, cfg, positions, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, a = _dense_layer(h, lp, cfg, positions)
        aux = aux + a
    return rmsnorm(h, params["final_norm"]), aux


def lm_logits(params: dict, hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return hidden @ cast(params["embed"]).t()
    return hidden @ cast(params["lm_head"])


# ---------------------------------------------------------------------------
# Prefill: one forward pass that also builds the decode caches
# ---------------------------------------------------------------------------


def _pad_full_cache(new: dict, out: dict):
    """Full-attention cache: each (B,S,...) leaf of ``new`` (K and V, or
    MLA's latent and rope key) into the first S slots of the zeroed cache
    ``out``."""
    for name, a in new.items():
        s, max_len = a.shape[1], out[name].shape[1]
        if s > max_len:
            raise ValueError(f"prompt of {s} tokens does not fit a {max_len}-slot cache")
        out[name][:, :s] = a


def _ring_cache(k, v, s_total, out):
    """Sliding-window ring: the last ``win`` tokens (the slots of the zeroed
    cache ``out``) at slots abs_pos % win."""
    win = out["k"].shape[1]
    take = min(k.shape[1], win)
    idx = torch.arange(s_total - take, s_total, device=k.device) % win
    out["k"][:, idx] = k[:, -take:]
    out["v"][:, idx] = v[:, -take:]


def lm_prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, max_len=None):
    """Forward the prompt once, writing each layer's decode cache as it goes.

    Returns (final_hidden (B,S,d), caches, pos (B,)) with the structure of
    ``init_caches``.
    """
    require_dense(cfg)
    b, s = tokens.shape
    max_len = max_len or s
    positions = _positions(tokens)
    caches = init_caches(cfg, b, max_len, device=tokens.device)
    h = _embed(params, tokens)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        out = _layer(caches["layers"], i)
        hn = rmsnorm(h, lp["ln1"])
        if cfg.use_mla:
            y, (ckv, k_rope) = attention.mla_attention(hn, lp["attn"], cfg, positions,
                                                       return_kv=True)
            _pad_full_cache({"ckv": ckv, "k_rope": k_rope}, out)
        else:
            y, (k, v) = attention.gqa_attention(hn, lp["attn"], cfg, positions, return_kv=True)
            if cfg.sliding_window is not None:
                _ring_cache(k, v, s, out)
            else:
                _pad_full_cache({"k": k, "v": v}, out)
        h, _ = _ffn(h + y, lp, cfg)
    h = rmsnorm(h, params["final_norm"])
    pos = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return h, caches, pos


# ---------------------------------------------------------------------------
# Decode (one token, stacked caches)
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """Stacked per-layer caches (leading dim = n_layers), zeros in bf16: MLA's
    latent cache, or K and V, of which a sliding-window arch keeps a ring of
    min(max_len, window) slots."""
    require_dense(cfg)
    if cfg.use_mla:
        one = attention.mla_init_cache(cfg, batch, max_len, device=device)
    else:
        eff = max_len if cfg.sliding_window is None else min(max_len, cfg.sliding_window)
        one = attention.gqa_init_cache(cfg, batch, eff, device=device)
    return {"layers": {name: a.new_zeros((cfg.n_layers,) + a.shape) for name, a in one.items()}}


def _decode_dense_layer(h, lp, cache_l, cfg: ModelConfig, pos, bias=None):
    hn = rmsnorm(h, lp["ln1"])
    if cfg.use_mla:
        a, new_cache = attention.mla_decode(hn, lp["attn"], cfg, cache_l, pos, bias=bias)
    else:
        a, new_cache = attention.gqa_decode(
            hn, lp["attn"], cfg, cache_l, pos, ring=cfg.sliding_window is not None, bias=bias)
    h, _ = _ffn(h + a, lp, cfg)
    return h, new_cache


def lm_decode_hidden(
    params: dict,
    token: torch.Tensor,  # (B, 1) int
    caches: dict,
    pos: torch.Tensor,  # (B,) int number of tokens already in cache
    cfg: ModelConfig,
) -> tuple[torch.Tensor, dict]:
    """One decode step -> final hidden (B, 1, d) and the caches, written in
    place (the same tensors come back)."""
    require_dense(cfg)
    h = _embed(params, token)
    stacked = caches["layers"]
    # Every layer attends over the same slots: one mask for the step.
    cache_len = next(iter(stacked.values())).shape[2]
    bias = attention.decode_bias(cfg, pos, cache_len, cfg.sliding_window is not None)
    for i in range(cfg.n_layers):
        h, _ = _decode_dense_layer(h, _layer(params["layers"], i), _layer(stacked, i),
                                   cfg, pos, bias)
    return rmsnorm(h, params["final_norm"]), caches
