"""Top-level model API, the serving half (PyTorch counterpart of
``repro/models/model.py``): build / prefill / serve_step / decode_step /
serve_apply_labels.

Every backbone carries the paper's ODL head: ``serve_step`` decodes one
token, then the fleet engine's ``gate`` runs on each stream's last hidden
state (the ODLHash projection kernel and the plan's per-stream pass on the
card): the per-stream prediction, the P1P2/auto-theta decision of which
streams must consult the teacher (a ``GateOutput`` with the ``queried``
mask and the plan-time decision context), the drift detector and the comm
meter.  Label application is asynchronous: ``serve_apply_labels`` is fed
the same ``GateOutput``, so a delayed answer is judged at query-time
context, and runs the fleet RLS kernel.  ``decode_step`` is the gate-free
variant the multiplexed serving path uses.

A step writes the KV caches in place: the ``ServeState`` passed in is
consumed, as the reference's jitted serving loop donates it.

Training (``train_step``, ``odl_update``, the optimizer) waits for a later
slice (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch import engine, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import drift as drift_mod
from repro_torch.core import oselm, pruning
from repro_torch.models import layers, transformer

# ---------------------------------------------------------------------------
# Schema / configs / params
# ---------------------------------------------------------------------------


def build_schema(cfg: ModelConfig) -> dict:
    transformer.require_dense(cfg)
    return transformer.lm_schema(cfg)


def elm_config(cfg: ModelConfig) -> oselm.OSELMConfig:
    return oselm.OSELMConfig(
        n_in=cfg.d_model,
        n_hidden=cfg.odl.n_hidden,
        n_out=cfg.odl.n_out,
        variant=cfg.odl.variant,
        seed=cfg.odl.seed,
        ridge=cfg.odl.ridge,
        use_kernel=cfg.odl.use_kernel,
    )


@functools.lru_cache(maxsize=32)
def core_config(cfg: ModelConfig) -> engine.EngineConfig:
    """Fleet-engine config for this backbone's per-stream ODL heads."""
    ecfg = elm_config(cfg)
    return engine.EngineConfig(
        elm=ecfg,
        prune=pruning.PruneConfig.for_hidden(ecfg.n_hidden),
        drift=drift_mod.DriftConfig(),
    )


def build_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """A serving model's params from ``seed`` on ``device`` (CUDA unless
    named): matmul and embedding weights in bf16, norm weights in f32."""
    return layers.init_params(build_schema(cfg), seed, device, dtype=layers.serving_dtype)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


class ServeState(NamedTuple):
    caches: dict
    pos: torch.Tensor  # (B,) int32
    odl: engine.EngineState  # fleet engine: elm/prune/drift/meter, leading B


def init_serve_state(cfg: ModelConfig, batch: int, max_len: int, device=None) -> ServeState:
    device = resolve_device(device)
    return ServeState(
        caches=transformer.init_caches(cfg, batch, max_len, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
        odl=engine.init_fleet(core_config(cfg), batch, device),
    )


def _decode(params, state: ServeState, token, cfg):
    with torch.profiler.record_function("serve.backbone"):
        hidden, caches = transformer.lm_decode_hidden(params, token, state.caches, state.pos, cfg)
        logits = transformer.lm_logits(params, hidden, cfg)[:, 0]
    return logits, hidden[:, 0].float(), caches


def serve_step(
    params: dict,
    state: ServeState,
    token: torch.Tensor,  # (B, 1) int
    cfg: ModelConfig,
) -> tuple[torch.Tensor, ServeState, engine.GateOutput]:
    """One decode token + the fleet engine's predict/gate on stream features.

    Returns (logits (B, V), state', odl_out) where odl_out is the engine's
    ``GateOutput``: the per-stream prediction, confidence, ``queried`` mask
    (True -> this stream must consult the teacher), and the plan-time
    decision context that ``serve_apply_labels`` judges the (possibly
    delayed) teacher answer against.
    """
    logits, feats, caches = _decode(params, state, token, cfg)
    with torch.profiler.record_function("serve.head"):
        new_odl, odl_out = engine.gate(state.odl, feats, core_config(cfg))
    return logits, ServeState(caches=caches, pos=state.pos + 1, odl=new_odl), odl_out


def decode_step(
    params: dict,
    state: ServeState,
    token: torch.Tensor,  # (B, 1) int
    cfg: ModelConfig,
) -> tuple[torch.Tensor, torch.Tensor, ServeState]:
    """One decode token *without* the ODL gate: (logits, feats (B, d) f32,
    state').  The multiplexed serving path runs the backbone once and fans
    the features out to tenant fleets, each with its own engine state;
    ``state.odl`` passes through untouched."""
    logits, feats, caches = _decode(params, state, token, cfg)
    return logits, feats, state._replace(caches=caches, pos=state.pos + 1)


def serve_apply_labels(
    state: ServeState,
    ctx: engine.GateOutput,  # gate output captured at query time
    labels: torch.Tensor,  # (B,) teacher labels (valid where mask)
    mask: torch.Tensor,  # (B,) bool — streams whose teacher answered
    cfg: ModelConfig,
) -> ServeState:
    """Asynchronous label acquisition: RLS-train the per-stream heads
    against the query-time context ``ctx``."""
    with torch.profiler.record_function("serve.head"):
        new_odl = engine.apply_labels(state.odl, ctx, labels, mask, core_config(cfg))
    return state._replace(odl=new_odl)


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, max_len: Optional[int] = None):
    """Forward the prompt once and build decode caches, on the tokens'
    device.  Returns (final_hidden, ServeState ready for serve_step)."""
    hidden, caches, pos = transformer.lm_prefill(params, tokens, cfg, max_len)
    state = ServeState(
        caches=caches, pos=pos,
        odl=engine.init_fleet(core_config(cfg), tokens.shape[0], tokens.device),
    )
    return hidden, state
