"""RG-LRU recurrent block (Griffin / RecurrentGemma; PyTorch counterpart of
``repro/models/rglru.py``).

Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)           (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The prefill runs the recurrence as a log-depth doubling scan over time
(``linear_scan``: the reference's associative-scan combine at offsets 1, 2,
4, ..., out of place); decode carries the (B, W) f32 state in O(1), written
into the cache it is given (or into ``out``, as ``ssm.ssd_decode``).  The
residual block is Griffin's: conv1d(4) temporal mixing + RG-LRU inside a
gated (GeGLU-style) branch pair.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import census
from repro_torch.models.layers import Leaf, dot
from repro_torch.models.ssm import causal_conv, conv_step

_C = 8.0


def rglru_schema(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "in_x": Leaf((d, w), ("embed", "mlp")),
        "in_gate": Leaf((d, w), ("embed", "mlp")),
        "conv_w": Leaf((4, w), (None, "mlp"), scale=0.5),
        "conv_b": Leaf((w,), ("mlp",), init="zeros"),
        "w_r": Leaf((w, w), ("mlp", None), scale=0.02),
        "w_i": Leaf((w, w), ("mlp", None), scale=0.02),
        "lam": Leaf((w,), ("mlp",), init="ones"),  # softplus(lam) > 0
        "out": Leaf((w, d), ("mlp", "embed")),
    }


@functools.lru_cache(maxsize=8)
def _const(c: float, dtype: torch.dtype) -> float:
    """c rounded to ``dtype``, as jnp rounds a constant to its operand's."""
    with census.uncounted():
        return float(torch.tensor(c, dtype=dtype))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True)'s steps, each rounded in x's dtype, its
    constants too: x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))).
    (``F.gelu(approximate="tanh")`` rounds once, and in bf16 four values
    in ten land one ulp from the reference's.)"""
    inner = _const(math.sqrt(2.0 / math.pi), x.dtype) * (
        x + _const(0.044715, x.dtype) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid in x's dtype: 1 / (1 + exp(-x)), each step rounded."""
    return 1.0 / (1.0 + torch.exp(-x))


def _gates(xw, p):
    """(a, gated), both f32, of the conv output xw (B, S, W)."""
    r = sigmoid(dot(xw, p["w_r"]))
    i = sigmoid(dot(xw, p["w_i"]))
    log_a = -_C * F.softplus(p["lam"].float())[None, None, :] * r.float()
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9)) * (
        i.float() * xw.float())
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over dim 1 from h_{-1} = 0, as a doubling
    scan: at offsets 1, 2, 4, ... every element combines with the one that
    far before it, (a_l, h_l), (a_r, h_r) -> (a_l a_r, h_r + a_r h_l), out
    of place.  log2(S) steps of a few launches each."""
    s, k = a.shape[1], 1
    while k < s:
        b = torch.cat([b[:, :k], b[:, k:] + a[:, k:] * b[:, :-k]], 1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], 1)
        k *= 2
    return b


def rglru_block(x: torch.Tensor, p: dict, cfg: ModelConfig, return_cache: bool = False):
    """x: (B, S, d) -> (B, S, d).  With ``return_cache``, also the decode
    cache: the last state and the last 3 conv inputs, both f32."""
    if return_cache and x.shape[1] < 3:
        raise ValueError(f"a prompt of {x.shape[1]} tokens is shorter than the RG-LRU conv's "
                         "3-token cache; prefill at least that many")
    gate = gelu_tanh(dot(x, p["in_gate"]))
    xw_raw = dot(x, p["in_x"])
    xw = causal_conv(xw_raw, p["conv_w"], p["conv_b"])
    a, gated = _gates(xw, p)
    h = linear_scan(a, gated)
    out = dot(h.to(x.dtype) * gate, p["out"])
    if return_cache:
        return out, {"h": h[:, -1], "conv": xw_raw[:, -3:].float()}
    return out


def rglru_init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=dtype, device=device),
        "conv": torch.zeros((batch, 3, w), dtype=dtype, device=device),
    }


def rglru_decode(x: torch.Tensor, p: dict, cfg: ModelConfig, cache: dict,
                 out: Optional[dict] = None):
    """x: (B, 1, d) -> (y, cache'): the new state and conv tail written
    into ``out`` (default: ``cache`` itself, in place) and returned."""
    out = cache if out is None else out
    gate = gelu_tanh(dot(x, p["in_gate"]))
    win, xw = conv_step(cache["conv"], dot(x, p["in_x"]), p["conv_w"], p["conv_b"])
    a, gated = _gates(xw[:, None, :], p)
    h = torch.mul(cache["h"], a[:, 0], out=out["h"]).add_(gated[:, 0])  # (B, W)
    out["conv"].copy_(win[:, 1:])
    y = h[:, None, :].to(x.dtype) * gate
    return dot(y, p["out"]), out
