"""Decoder-only LM assembly, the dense and MoE paths (PyTorch counterpart
of ``repro/models/transformer.py``).

One code path serves the nine decoder-only archs of four families:

  dense  — GQA attention (+ optional sliding window / qk_norm) + SwiGLU:
           h2o-danube-1.8b, deepseek-coder-33b, mistral-nemo-12b, qwen3-4b
           and chameleon-34b (a dense stack behind a frontend stub);
  moe    — GQA or MLA attention + fine-grained MoE: deepseek-moe-16b,
           deepseek-v2-236b (every layer MoE, as the reference's configs);
  ssm    — the Mamba-2 SSD mixer alone: mamba2-780m;
  hybrid — Griffin's pattern (rec, rec, attn), each sub-block with its
           MLP: recurrentgemma-9b.

Layers keep the reference's stacked layout (a leading L dim on every layer
leaf, so a converted param tree is a plain copy) and run as a loop over
that dim; a hybrid stack stacks pattern groups (``{"groups": {"b0_rec":
..., "b1_rec": ..., "b2_attn": ...}}``, leading dim the group count) plus
a one-deep ``tail`` stack of the first n_layers % len(pattern) sub-blocks.
Caches keep the reference's structure too (``{"layers": {"k": (L, B, S,
KV, hd), "v": ...}}``, ``{"layers": {"ckv": ..., "k_rope": ...}}`` with
MLA, ``{"layers": {"state", "conv"}}`` for the SSD stack, and the hybrid
``{"groups": {...}, "tail": {...}}`` of RG-LRU ``{"h", "conv"}`` and the
local attention's ring of K and V).  ``lm_hidden`` is the training forward
too, with the reference's remat, and sums the MoE layers' aux loss in
layer order as the reference's scan carry does.

The encoder-decoder (whisper) has entry points of its own
(``model.encdec_prefill``, ``encdec.decode_step``): the ones here raise
``NotImplementedError`` for it, as the reference's have no enc-dec branch.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import attention, moe, rglru, ssm
from repro_torch.models.layers import (Leaf, cast, model_split, rmsnorm, stack_schema, swiglu,
                                       swiglu_tp, vocab_parallel_embed)


def require_dense(cfg: ModelConfig) -> None:
    """Raise for the encoder-decoder, which the decoder-only entry points
    here do not run (dense, MoE, SSD and hybrid stacks do)."""
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.arch_id}: the encoder-decoder (whisper) is not a decoder-only stack; its "
            "entry points are model.encdec_prefill and encdec.decode_step (encdec.encode and "
            "encdec.decode_train to train)")


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------


def _mlp_schema(cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "wg": Leaf((d, ff), ("embed", "mlp")),
        "wu": Leaf((d, ff), ("embed", "mlp")),
        "wd": Leaf((ff, d), ("mlp", "embed")),
    }


def _mixer_schema(cfg: ModelConfig) -> dict:
    require_dense(cfg)
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"norm": Leaf((d,), ("embed",), init="zeros"), "ssd": ssm.ssd_schema(cfg)}
    s: dict = {"ln1": Leaf((d,), ("embed",), init="zeros")}
    s["attn"] = attention.mla_schema(cfg) if cfg.use_mla else attention.gqa_schema(cfg)
    s["ln2"] = Leaf((d,), ("embed",), init="zeros")
    if cfg.n_experts:
        s["moe"] = moe.moe_schema(cfg)
    else:
        s["mlp"] = _mlp_schema(cfg)
    return s


def _hybrid_sub_schema(cfg: ModelConfig, kind: str) -> dict:
    """A sub-block of kind "rec" (RG-LRU) or "attn" (local GQA), its mixer
    under that key, with its MLP."""
    d = cfg.d_model
    s: dict = {"ln1": Leaf((d,), ("embed",), init="zeros")}
    s[kind] = rglru.rglru_schema(cfg) if kind == "rec" else attention.gqa_schema(cfg)
    s["ln2"] = Leaf((d,), ("embed",), init="zeros")
    s["mlp"] = _mlp_schema(cfg)
    return s


def _pattern_keys(cfg: ModelConfig, n: int) -> list:
    """(key, kind) of the first n sub-blocks of a hybrid group."""
    return [(f"b{i}_{kind}", kind) for i, kind in enumerate(cfg.hybrid_pattern[:n])]


def _hybrid_stacks(cfg: ModelConfig) -> list:
    """(name, depth, [(key, kind), ...]) of the hybrid stacks: the pattern
    groups, then a one-deep tail of n_layers % len(pattern) sub-blocks."""
    n_groups, tail = divmod(cfg.n_layers, len(cfg.hybrid_pattern))
    stacks = [("groups", n_groups, _pattern_keys(cfg, len(cfg.hybrid_pattern)))]
    if tail:
        stacks.append(("tail", 1, _pattern_keys(cfg, tail)))
    return stacks


def lm_schema(cfg: ModelConfig) -> dict:
    require_dense(cfg)
    s: dict = {
        "embed": Leaf((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), init="embed"),
        "final_norm": Leaf((cfg.d_model,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = Leaf((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    if cfg.hybrid_pattern:
        for name, depth, keys in _hybrid_stacks(cfg):
            s[name] = stack_schema({k: _hybrid_sub_schema(cfg, kind) for k, kind in keys}, depth)
    else:
        s["layers"] = stack_schema(_mixer_schema(cfg), cfg.n_layers)
    return s


def _layer(stacked, i: int) -> dict:
    """Layer i's params: a view of every stacked leaf at index i, or item i
    of a list of per-layer trees (a training step's views, whose gradients
    it gathers: ``model.loss_and_grads``)."""
    if isinstance(stacked, list):
        return stacked[i]
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


def _ssm_layer(h, lp, cfg: ModelConfig, positions):
    del positions
    return h + ssm.ssd_block(rmsnorm(h, lp["norm"]), lp["ssd"], cfg), 0.0


def _hybrid_sub(h, sp, kind: str, cfg: ModelConfig, positions, out=None):
    """One sub-block: its mixer (RG-LRU, or local attention over the
    window) and its MLP.  With ``out`` (its slot of the stacked caches), a
    prefill: also writes the RG-LRU cache, or the ring of the last
    min(max_len, window) tokens' K and V."""
    hn = rmsnorm(h, sp["ln1"])
    if kind == "rec":
        y = rglru.rglru_block(hn, sp["rec"], cfg, return_cache=out is not None)
        if out is not None:
            y, new = y
            _copy_cache(new, out)
    else:
        y = attention.gqa_attention(hn, sp["attn"], cfg, positions, window=cfg.sliding_window,
                                    return_kv=out is not None)
        if out is not None:
            y, (k, v) = y
            _ring_cache(k, v, h.shape[1], out)
    h = h + y
    hn = rmsnorm(h, sp["ln2"])
    return h + swiglu(hn, sp["mlp"]["wg"], sp["mlp"]["wu"], sp["mlp"]["wd"])


def _hybrid_group(h, gp, cfg: ModelConfig, positions):
    """One pattern group (or the tail): its sub-blocks in pattern order."""
    for key, kind in _pattern_keys(cfg, len(cfg.hybrid_pattern)):
        if key in gp:
            h = _hybrid_sub(h, gp[key], kind, cfg, positions)
    return h, 0.0


def _stack_fns(params: dict, cfg: ModelConfig):
    """(layer function, its params) for every layer or group in order."""
    if cfg.hybrid_pattern:
        return [(_hybrid_group, _layer(params[name], i))
                for name, depth, _ in _hybrid_stacks(cfg) for i in range(depth)]
    fn = _ssm_layer if cfg.family == "ssm" else _dense_layer
    return [(fn, _layer(params["layers"], i)) for i in range(cfg.n_layers)]


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)


def lm_hidden(
    params: dict,
    tokens: torch.Tensor,  # (B, S) int
    cfg: ModelConfig,
    positions: Optional[torch.Tensor] = None,
    remat: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | float]:
    """Token ids -> final hidden states (B, S, d) [compute dtype], aux loss
    (the MoE layers' sum, a 0-d f32 tensor; 0.0 for a dense stack).

    A dense, MoE or SSD stack runs its layers, a hybrid stack its groups and
    then its tail; a stacked subtree of ``params`` may be a list of its
    layers' trees (``_layer``).

    ``remat`` recomputes each layer (each group of a hybrid stack) in the
    backward pass instead of keeping its activations
    (``torch.utils.checkpoint``, the counterpart of the reference's
    ``jax.checkpoint`` with ``nothing_saveable``): it applies only where
    autograd records the stack, so serving runs as it did."""
    require_dense(cfg)
    if positions is None:
        positions = _positions(tokens)
    h, aux = run_layers(_embed(params, tokens), _stack_fns(params, cfg), remat, cfg, positions)
    return rmsnorm(h, params["final_norm"]), aux


def run_layers(h, fns, remat: bool, *args):
    """``fn(h, lp, *args)`` -> (h, aux) for each (fn, lp) of ``fns`` in
    order: the last h and the aux losses' sum.  With ``remat``, and where
    autograd records the stack, each call is recomputed in the backward pass
    instead of keeping its activations."""
    recompute = remat and torch.is_grad_enabled() and h.requires_grad
    captured = sharding.scope()
    aux = 0.0
    for fn, lp in fns:
        if recompute:
            h, a = checkpoint(_scoped, captured, fn, h, lp, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, a = fn(h, lp, *args)
        aux = aux + a
    return h, aux


def _scoped(captured, fn, *args):
    """``fn(*args)`` in the sharding scope the forward pass ran in: remat
    recomputes it in the backward pass, which on the card autograd runs on
    a thread of its own, where no scope is current (an MoE layer would run
    the dense block there instead of the EP block)."""
    with sharding.within(captured):
        return fn(*args)


def lm_logits(params: dict, hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return hidden @ cast(params["embed"]).t()
    return hidden @ cast(params["lm_head"])


# ---------------------------------------------------------------------------
# The partitioned forward (training a dense or MoE stack on a (data, model)
# mesh)
# ---------------------------------------------------------------------------
#
# Each leaf is held as its ``Placement``'s slices, one per mesh position,
# and used in ``layers.compute_spec``'s layout: ``sharding.relayout``
# all-gathers the rest just before use (per layer for a stacked leaf, so
# remat gathers it again in the backward pass, as FSDP does).  A tensor in
# flight is a dict {mesh position: its slice}.  The residual stream of a
# data row's tokens is held by each position of its model row, the same
# bits at each: the partial products of wo and wd (or of the shared
# experts' wd) are summed over "model" in axis order before the residual
# add, and an MoE layer's routed experts run expert-parallel between the
# positions of a model row (``moe.moe_block_tp``).


def heads_split(cfg: ModelConfig, layout: dict) -> bool:
    """Whether the layer's attention splits its heads over "model": GQA's
    wq, or MLA's wq_b, on the heads dim."""
    return model_split(layout["attn/wq_b" if cfg.use_mla else "attn/wq"][1], 1)


def ffn_split(cfg: ModelConfig, layout: dict) -> bool:
    """Whether the layer's dense MLP (or an MoE layer's shared experts)
    splits its d_ff over "model" (wd row-parallel): a reduction of the
    residual stream over "model"."""
    if cfg.n_experts:
        return "moe/shared/wd" in layout and model_split(layout["moe/shared/wd"][1], 0)
    return model_split(layout["mlp/wd"][1], 0)


def dense_layer_tp(h: dict, lp: dict, cfg: ModelConfig, positions: dict, mesh,
                   layout: dict):
    """One layer of a dense or MoE stack on ``mesh``, as ``_dense_layer``:
    GQA or MLA attention, then SwiGLU or the MoE block (``moe.moe_block_tp``).
    h {pos: (B_loc, S, d)}; ``lp`` {path in the layer: {pos: slice}} and
    ``layout`` {path: (held spec, compute spec)} without the layers dim.
    Returns (h, aux): the MoE block's aux on the mesh's first entry, 0.0
    for a dense layer."""
    w = {k: sharding.relayout(v, *layout[k], mesh) for k, v in lp.items()}
    hn = {pos: rmsnorm(x, w["ln1"][pos]) for pos, x in h.items()}
    if cfg.use_mla:
        a = attention.mla_attention_tp(hn, _subtree(w, "attn/"), cfg, positions, mesh,
                                       heads_split=heads_split(cfg, layout))
    else:
        a = attention.gqa_attention_tp(hn, _subtree(w, "attn/"), cfg, positions, mesh,
                                       heads_split=heads_split(cfg, layout),
                                       kv_split=model_split(layout["attn/wk"][1], 1))
    h = {pos: x + a[pos] for pos, x in h.items()}
    hn = {pos: rmsnorm(x, w["ln2"][pos]) for pos, x in h.items()}
    if cfg.n_experts:
        y, aux = moe.moe_block_tp(hn, _subtree(w, "moe/"), cfg, mesh, _subtree(layout, "moe/"))
    else:
        y = swiglu_tp(hn, w["mlp/wg"], w["mlp/wu"], w["mlp/wd"], mesh,
                      split=ffn_split(cfg, layout))
        aux = 0.0
    return {pos: x + y[pos] for pos, x in h.items()}, aux


def _subtree(flat: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


def lm_hidden_tp(top: dict, stacked: dict, tokens: dict, cfg: ModelConfig, mesh, layout: dict,
                 remat: bool = True):
    """``lm_hidden`` of a dense or MoE stack on ``mesh``: token ids {pos:
    (B_loc, S)} -> (final hidden states {pos: (B_loc, S, d)}, the aux loss
    summed over the layers in order on the mesh's first entry, 0.0 for a
    dense stack).  ``top`` holds the top-level leaves {name: {pos: slice}},
    ``stacked`` the layer leaves {path in the layer: [{pos: slice} per
    layer]}; ``layout`` the held and compute specs of both (a layer leaf's
    without the layers dim).  With ``remat`` each layer, its gathers
    included, is recomputed in the backward pass in the forward's mesh
    scope, up to the last tensor the backward needs (not its last
    reductions over "model", nor an MoE layer's aux gather); it routes as
    the forward did (the same ops on the same inputs)."""
    positions = {pos: _positions(t) for pos, t in tokens.items()}
    embed = sharding.relayout(top["embed"], *layout["embed"], mesh)
    h = vocab_parallel_embed(tokens, embed, mesh, split=model_split(layout["embed"][1], 0))
    recompute = remat and torch.is_grad_enabled()
    captured = sharding.scope()
    aux = 0.0
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in stacked.items()}
        args = (h, lp, cfg, positions, mesh, layout)
        if recompute:
            # Early stop: the recompute ends at the last tensor the backward
            # needs, before the layer's last reductions over "model".
            with set_checkpoint_early_stop(True):
                h, a = checkpoint(_scoped, captured, dense_layer_tp, *args, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            h, a = dense_layer_tp(*args)
        aux = aux + a
    norm = sharding.relayout(top["final_norm"], *layout["final_norm"], mesh)
    return {pos: rmsnorm(x, norm[pos]) for pos, x in h.items()}, aux


def lm_logits_tp(top: dict, hidden: dict, cfg: ModelConfig, mesh, layout: dict) -> dict:
    """``lm_logits`` on ``mesh``: {pos: (B_loc, S, V)}, or each position's
    block of the vocabulary where the head splits it over "model"."""
    name = "embed" if cfg.tie_embeddings else "lm_head"
    w = sharding.relayout(top[name], *layout[name], mesh)
    if cfg.tie_embeddings:
        return {pos: x @ cast(w[pos]).t() for pos, x in hidden.items()}
    return {pos: x @ cast(w[pos]) for pos, x in hidden.items()}


def vocab_split(cfg: ModelConfig, layout: dict) -> bool:
    """Whether ``lm_logits_tp`` gives each position a block of the
    vocabulary."""
    if cfg.tie_embeddings:
        return model_split(layout["embed"][1], 0)
    return model_split(layout["lm_head"][1], 1)


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


def _copy_cache(new: dict, out: dict):
    """A recurrent block's prefill cache into its slot of the stacked cache."""
    for name, a in new.items():
        out[name].copy_(a)


def _hybrid_prefill(h, params, caches, cfg: ModelConfig, positions):
    """The hybrid stack's forward, writing every sub-block's cache as it
    goes."""
    for name, depth, keys in _hybrid_stacks(cfg):
        for g in range(depth):
            gp, gc = _layer(params[name], g), _layer(caches[name], g)
            for key, kind in keys:
                h = _hybrid_sub(h, gp[key], kind, cfg, positions, gc[key])
    return h


def _dense_prefill(h, params, caches, cfg: ModelConfig, positions):
    """The dense or MoE stack's forward, writing each layer's K and V (a
    ring with a sliding window) or MLA's latent cache as it goes."""
    s = h.shape[1]
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
    return h


def _ssm_prefill(h, params, caches, cfg: ModelConfig, positions):
    """The SSD stack's forward, writing each layer's final state and conv
    tail as it goes."""
    del positions
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        y, new = ssm.ssd_block(rmsnorm(h, lp["norm"]), lp["ssd"], cfg, return_cache=True)
        _copy_cache(new, _layer(caches["layers"], i))
        h = h + y
    return h


def lm_prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, max_len=None):
    """Forward the prompt once, writing each layer's decode cache as it goes.

    Returns (final_hidden (B,S,d), caches, pos (B,)) with the structure of
    ``init_caches``.  An SSD stack needs S to be a multiple of
    min(ssm_chunk, S); recurrent blocks need S >= their conv's W - 1 = 3.
    """
    require_dense(cfg)
    b, s = tokens.shape
    max_len = max_len or s
    positions = _positions(tokens)
    caches = init_caches(cfg, b, max_len, device=tokens.device)
    fill = (_hybrid_prefill if cfg.hybrid_pattern else
            _ssm_prefill if cfg.family == "ssm" else _dense_prefill)
    h = fill(_embed(params, tokens), params, caches, cfg, positions)
    h = rmsnorm(h, params["final_norm"])
    pos = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return h, caches, pos


# ---------------------------------------------------------------------------
# Decode (one token, stacked caches)
# ---------------------------------------------------------------------------


def _stacked(one: dict, n: int) -> dict:
    return {name: a.new_zeros((n,) + a.shape) for name, a in one.items()}


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """Stacked per-layer caches (leading dim = n_layers, or the group count
    of a hybrid stack), zeros in the reference's dtypes: the attention
    caches (MLA's latent cache, or K and V, of which a sliding-window arch
    and the hybrid stack's local attention keep a ring of min(max_len,
    window) slots) in bf16; the SSD state and conv tail and the RG-LRU
    state and conv tail in f32."""
    require_dense(cfg)
    if cfg.hybrid_pattern:
        slots = min(max_len, cfg.sliding_window or max_len)
        one = {"rec": rglru.rglru_init_cache(cfg, batch, device=device),
               "attn": attention.gqa_init_cache(cfg, batch, slots, device=device)}
        return {name: {key: _stacked(one[kind], depth) for key, kind in keys}
                for name, depth, keys in _hybrid_stacks(cfg)}
    if cfg.family == "ssm":
        one = ssm.ssd_init_cache(cfg, batch, device=device)
    elif cfg.use_mla:
        one = attention.mla_init_cache(cfg, batch, max_len, device=device)
    else:
        eff = max_len if cfg.sliding_window is None else min(max_len, cfg.sliding_window)
        one = attention.gqa_init_cache(cfg, batch, eff, device=device)
    return {"layers": _stacked(one, cfg.n_layers)}


def _decode_dense_layer(h, lp, cache_l, cfg: ModelConfig, pos, bias=None, out=None):
    del out  # attention caches are written in place
    hn = rmsnorm(h, lp["ln1"])
    if cfg.use_mla:
        a, new_cache = attention.mla_decode(hn, lp["attn"], cfg, cache_l, pos, bias=bias)
    else:
        a, new_cache = attention.gqa_decode(
            hn, lp["attn"], cfg, cache_l, pos, ring=cfg.sliding_window is not None, bias=bias)
    h, _ = _ffn(h + a, lp, cfg)
    return h, new_cache


def _decode_ssm_layer(h, lp, cache_l, cfg: ModelConfig, pos, bias=None, out=None):
    del pos, bias
    y, new_cache = ssm.ssd_decode(rmsnorm(h, lp["norm"]), lp["ssd"], cfg, cache_l, out)
    return h + y, new_cache


def _decode_hybrid_sub(h, sp, cache_s, kind, cfg: ModelConfig, pos, bias, out):
    hn = rmsnorm(h, sp["ln1"])
    if kind == "rec":
        y, new_cache = rglru.rglru_decode(hn, sp["rec"], cfg, cache_s, out)
    else:
        # Local attention over a ring buffer of the last `window` tokens.
        y, new_cache = attention.gqa_decode(hn, sp["attn"], cfg, cache_s, pos, ring=True,
                                            bias=bias)
    h = h + y
    hn = rmsnorm(h, sp["ln2"])
    return h + swiglu(hn, sp["mlp"]["wg"], sp["mlp"]["wu"], sp["mlp"]["wd"]), new_cache


def lm_decode_hidden(
    params: dict,
    token: torch.Tensor,  # (B, 1) int
    caches: dict,
    pos: torch.Tensor,  # (B,) int number of tokens already in cache
    cfg: ModelConfig,
    out: Optional[dict] = None,
) -> tuple[torch.Tensor, dict]:
    """One decode step -> final hidden (B, 1, d) and the caches, written in
    place (the same tensors come back).

    With ``out`` (a cache tree like ``caches``), the recurrent leaves' new
    values (the SSD and RG-LRU states and conv tails) go into ``out``'s
    leaves instead, and ``caches``' stay as they were; attention caches are
    written in place either way, and ``out`` comes back.  A step that reads
    one set and writes the other can run twice on the same inputs with the
    same result, as a CUDA graph's warm-up and capture need."""
    require_dense(cfg)
    h = _embed(params, token)
    out_tree = caches if out is None else out
    if cfg.hybrid_pattern:
        # Every attention sub-block attends over the same ring: one mask
        # for the step, from the first one's slots.
        name, _, keys = _hybrid_stacks(cfg)[0]
        attn = [key for key, kind in keys if kind == "attn"]
        bias = None if not attn else attention.decode_bias(
            pos, caches[name][attn[0]]["k"].shape[2], ring=True, window=cfg.sliding_window)
        for name, depth, keys in _hybrid_stacks(cfg):
            for g in range(depth):
                gp, gc, go = (_layer(t[name], g) for t in (params, caches, out_tree))
                for key, kind in keys:
                    h, _ = _decode_hybrid_sub(h, gp[key], gc[key], kind, cfg, pos, bias,
                                              go[key])
        return rmsnorm(h, params["final_norm"]), out_tree
    stacked = caches["layers"]
    if cfg.family == "ssm":
        layer, bias = _decode_ssm_layer, None
    else:
        # Every layer attends over the same slots: one mask for the step.
        layer = _decode_dense_layer
        cache_len = next(iter(stacked.values())).shape[2]
        window = None if cfg.use_mla else cfg.sliding_window
        bias = attention.decode_bias(pos, cache_len, window is not None, window)
    for i in range(cfg.n_layers):
        h, _ = layer(h, _layer(params["layers"], i), _layer(stacked, i), cfg, pos, bias,
                     _layer(out_tree["layers"], i))
    return rmsnorm(h, params["final_norm"]), out_tree
