"""Decoder-only LM assembly, the dense path (PyTorch counterpart of
``repro/models/transformer.py``).

One code path serves the dense archs: GQA attention (+ optional sliding
window / qk_norm) + SwiGLU — h2o-danube-1.8b, deepseek-coder-33b,
mistral-nemo-12b, qwen3-4b and chameleon-34b (a dense stack behind a
frontend stub).  Layers keep the reference's stacked layout (a leading L
dim on every layer leaf, so a converted param tree is a plain copy) and run
as a loop over that dim; caches keep the reference's structure too
(``{"layers": {"k": (L, B, S, KV, hd), "v": ...}}``).

Experts, MLA, the SSD scan and hybrid RG-LRU stacks raise
``NotImplementedError``: ROADMAP Queue 1 item 6 ports them in later slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention
from repro_torch.models.layers import Leaf, cast, rmsnorm, stack_schema, swiglu


def require_dense(cfg: ModelConfig) -> None:
    """Raise for the families the port has no backbone for yet."""
    missing = None
    if cfg.enc_dec:
        missing = "the encoder-decoder (whisper)"
    elif cfg.family == "ssm":
        missing = "the SSD scan (mamba2)"
    elif cfg.hybrid_pattern:
        missing = "the hybrid RG-LRU stack (recurrentgemma)"
    elif cfg.n_experts:
        missing = "MoE (dense and EP)"
    elif cfg.use_mla:
        missing = "MLA attention"
    if missing is not None:
        raise NotImplementedError(
            f"{cfg.arch_id}: {missing} is not ported yet; ROADMAP Queue 1 item 6 "
            "lists it after the dense serving path")


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------


def _mixer_schema(cfg: ModelConfig) -> dict:
    require_dense(cfg)
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "ln1": Leaf((d,), ("embed",), init="zeros"),
        "attn": attention.gqa_schema(cfg),
        "ln2": Leaf((d,), ("embed",), init="zeros"),
        "mlp": {
            "wg": Leaf((d, ff), ("embed", "mlp")),
            "wu": Leaf((d, ff), ("embed", "mlp")),
            "wd": Leaf((ff, d), ("mlp", "embed")),
        },
    }


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


def _dense_layer(h, lp, cfg: ModelConfig, positions):
    hn = rmsnorm(h, lp["ln1"])
    h = h + attention.gqa_attention(hn, lp["attn"], cfg, positions)
    hn = rmsnorm(h, lp["ln2"])
    return h + swiglu(hn, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"])


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)


def lm_hidden(
    params: dict,
    tokens: torch.Tensor,  # (B, S) int
    cfg: ModelConfig,
    positions: Optional[torch.Tensor] = None,
    remat: bool = True,
) -> tuple[torch.Tensor, float]:
    """Token ids -> final hidden states (B, S, d) [compute dtype], aux loss
    (0.0: a dense stack has none).  ``remat`` is the reference's training
    switch and does nothing when serving."""
    del remat
    require_dense(cfg)
    if positions is None:
        positions = _positions(tokens)
    h = _embed(params, tokens)
    for i in range(cfg.n_layers):
        h = _dense_layer(h, _layer(params["layers"], i), cfg, positions)
    return rmsnorm(h, params["final_norm"]), 0.0


def lm_logits(params: dict, hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return hidden @ cast(params["embed"]).t()
    return hidden @ cast(params["lm_head"])


# ---------------------------------------------------------------------------
# Prefill: one forward pass that also builds the decode caches
# ---------------------------------------------------------------------------


def _pad_full_cache(k, v, out):
    """Full-attention cache: (B,S,KV,hd) K/V into the first S slots of the
    zeroed cache ``out``."""
    s, max_len = k.shape[1], out["k"].shape[1]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit a {max_len}-slot cache")
    out["k"][:, :s] = k
    out["v"][:, :s] = v


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
    ck, cv = caches["layers"]["k"], caches["layers"]["v"]
    h = _embed(params, tokens)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        hn = rmsnorm(h, lp["ln1"])
        y, (k, v) = attention.gqa_attention(hn, lp["attn"], cfg, positions, return_kv=True)
        out = {"k": ck[i], "v": cv[i]}
        if cfg.sliding_window is not None:
            _ring_cache(k, v, s, out)
        else:
            _pad_full_cache(k, v, out)
        h = h + y
        hn = rmsnorm(h, lp["ln2"])
        h = h + swiglu(hn, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"])
    h = rmsnorm(h, params["final_norm"])
    pos = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return h, caches, pos


# ---------------------------------------------------------------------------
# Decode (one token, stacked caches)
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """Stacked per-layer caches (leading dim = n_layers), zeros in bf16; a
    sliding-window arch keeps a ring of min(max_len, window) slots."""
    require_dense(cfg)
    eff = max_len if cfg.sliding_window is None else min(max_len, cfg.sliding_window)
    one = attention.gqa_init_cache(cfg, batch, eff, device=device)
    return {"layers": {name: a.new_zeros((cfg.n_layers,) + a.shape) for name, a in one.items()}}


def _decode_dense_layer(h, lp, cache_l, cfg: ModelConfig, pos, bias=None):
    hn = rmsnorm(h, lp["ln1"])
    a, new_cache = attention.gqa_decode(
        hn, lp["attn"], cfg, cache_l, pos, ring=cfg.sliding_window is not None, bias=bias)
    h = h + a
    hn = rmsnorm(h, lp["ln2"])
    return h + swiglu(hn, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"]), new_cache


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
    ck, cv = caches["layers"]["k"], caches["layers"]["v"]
    # Every layer attends over the same slots: one mask for the step.
    bias = attention.decode_bias(cfg, pos, ck.shape[2], cfg.sliding_window is not None)
    for i in range(cfg.n_layers):
        h, _ = _decode_dense_layer(h, _layer(params["layers"], i), {"k": ck[i], "v": cv[i]},
                                   cfg, pos, bias)
    return rmsnorm(h, params["final_norm"]), caches
