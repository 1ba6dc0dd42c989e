"""Mamba-2 SSD (state-space duality) block, the chunked scan (PyTorch
counterpart of ``repro/models/ssm.py``).

Within chunks of length Q the recurrence is a masked quadratic form;
between chunks the (H, P, N) state is carried by a loop over the S/Q
chunks (the reference's associative scan over them: the same combine, in
order).  The intra-chunk, chunk-state and inter-chunk products are in f32,
each an elementwise product followed by one batched matmul over (b, n, h):
never a six-axis intermediate.

Decode keeps the (B, H, P, N) f32 state and a (B, W-1, conv_dim) f32 conv
tail, and advances one token in O(1).  It writes both into the cache it is
given (or into ``out``, a second cache of the same shapes, leaving the
first as it was: ``launch.serve._decode_feats`` alternates two such sets
under its CUDA graphs).

Shapes follow the reference:
  d_inner = expand * d_model;  H = d_inner / headdim;  N = ssm_state
  in_proj -> [z (d_inner), x (d_inner), B (N), C (N), dt (H)]
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Leaf, cast, dot, rmsnorm, silu

NEG_EXP = -1e9  # the masked exponent: exp of it is 0


def ssd_schema(cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    n, h = cfg.ssm_state, cfg.ssm_nheads
    conv_dim = di + 2 * n
    return {
        "in_proj": Leaf((d, 2 * di + 2 * n + h), ("embed", "mlp")),
        "conv_w": Leaf((cfg.ssm_conv_width, conv_dim), (None, "mlp"), scale=0.5),
        "conv_b": Leaf((conv_dim,), ("mlp",), init="zeros"),
        "a_log": Leaf((h,), ("ssm_heads",), init="zeros"),
        "dt_bias": Leaf((h,), ("ssm_heads",), init="zeros"),
        "d_skip": Leaf((h,), ("ssm_heads",), init="ones"),
        "norm": Leaf((di,), ("mlp",), init="zeros"),
        "out_proj": Leaf((di, d), ("mlp", "embed")),
    }


def _split_proj(zxbcdt, cfg: ModelConfig):
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    return torch.split(zxbcdt, [di, di, n, n, h], -1)  # z, x, B, C, dt


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv without activation; x: (B, S, C), w: (W, C).
    The taps are summed one by one in x's dtype, in tap order, then
    ``+ cast(b)``, as the reference's Python ``sum``."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    wc = cast(w)
    out = sum(pad[:, i:i + s, :] * wc[i][None, None, :] for i in range(width))
    return out + cast(b)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The SSD block's conv: ``causal_conv`` then silu."""
    return silu(causal_conv(x, w, b))


def conv_step(conv: torch.Tensor, new: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """One decode step of the conv: the window (B, W, C) in the cache's
    dtype (the cached W-1 inputs, then ``new`` (B, 1, C)) and its output
    (B, C): the bf16 window against cast(w) in one contraction
    (``einsum('bwc,wc->bc')``: f32 accumulation, one rounding), then
    ``+ cast(b)``."""
    win = torch.cat([conv, new.to(conv.dtype)], 1)
    wc = cast(w)
    out = (win.to(wc.dtype).float() * wc.float()).sum(1).to(wc.dtype)
    return win, out + cast(b)


def ssd_scan(xh, dt, a, bmat, cmat, chunk: int):
    """Chunked SSD.  xh: (B,S,H,P); dt: (B,S,H) >= 0; a: (H,) < 0 decay
    rates; bmat/cmat: (B,S,N), all f32.  Returns (B,S,H,P) and the final
    state (B,H,P,N).  Raises unless S is a multiple of min(chunk, S)."""
    bsz, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc = s // q

    da_c = (dt * a[None, None, :]).reshape(bsz, nc, q, h)  # log-decay per step
    xs = (xh * dt[..., None]).reshape(bsz, nc, q, h, p)  # dt-weighted input
    bs = bmat.reshape(bsz, nc, q, n)
    cs = cmat.reshape(bsz, nc, q, n)

    cum = torch.cumsum(da_c, dim=2)  # (B,nc,q,H) inclusive
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,i,j,H)
    iota = torch.arange(q, device=xh.device)
    causal = (iota[:, None] >= iota[None, :])[None, None, :, :, None]
    # Mask the exponent, not the exp: exp of a large positive non-causal
    # entry would be inf.
    decay_ij = torch.exp(torch.where(causal, seg, NEG_EXP))

    # Intra-chunk: Y[i] = sum_j<=i (C_i . B_j) decay(i, j) X_j.
    cb = torch.matmul(cs, bs.transpose(-1, -2))  # (B,nc,i,j)
    wij = (cb[..., None] * decay_ij).permute(0, 1, 4, 2, 3)  # (B,nc,H,i,j)
    y_intra = torch.matmul(wij, xs.permute(0, 1, 3, 2, 4))  # (B,nc,H,i,P)

    # Chunk summary states: S_n = sum_j decay(end, j) X_j^T B_j -> (B,nc,H,P,N).
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,nc,q,H)
    xe = (xs * decay_end[..., None]).permute(0, 1, 3, 4, 2)  # (B,nc,H,P,q)
    s_chunk = torch.matmul(xe, bs[:, :, None])  # (B,nc,H,P,N)

    # Inter-chunk recurrence: S_n = exp(sum da_n) S_{n-1} + s_chunk_n; the
    # state entering chunk n is S_{n-1} (zeros for the first).
    chunk_decay = torch.exp(da_c.sum(2))  # (B,nc,H)
    state = torch.zeros_like(s_chunk[:, 0])
    entering = []
    for c in range(nc):
        entering.append(state)
        state = chunk_decay[:, c, :, None, None] * state + s_chunk[:, c]
    s_prev = torch.stack(entering, 1)  # (B,nc,H,P,N)

    # Inter-chunk output: Y[i] = decay(i, start) C_i . S_prev.
    decay_in = torch.exp(cum).permute(0, 1, 3, 2)[..., None]  # (B,nc,H,q,1)
    y_inter = torch.matmul(cs[:, :, None], s_prev.transpose(-1, -2)) * decay_in  # (B,nc,H,q,P)

    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(bsz, s, h, p)
    return y, state


def ssd_block(x: torch.Tensor, p: dict, cfg: ModelConfig, return_cache: bool = False):
    """The Mamba-2 block: in_proj -> conv -> SSD -> gated norm -> out_proj.
    With ``return_cache``, also the decode cache: the final state and the
    last W-1 conv inputs, both f32."""
    di, h, hd = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    b_sz, s = x.shape[:2]
    w = cfg.ssm_conv_width
    if return_cache and s < w - 1:
        raise ValueError(f"a prompt of {s} tokens is shorter than the SSD conv's {w - 1}-token "
                         "cache; prefill at least that many")
    z, xr, b, c, dt = _split_proj(dot(x, p["in_proj"]), cfg)
    xbc_raw = torch.cat([xr, b, c], -1)
    xr, b, c = torch.split(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]),
                           [di, cfg.ssm_state, cfg.ssm_state], -1)

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())  # (H,) negative rates
    xh = xr.reshape(b_sz, s, h, hd).float()
    y, final_state = ssd_scan(xh, dt, a, b.float(), c.float(), cfg.ssm_chunk)
    y = y + xh * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(b_sz, s, di).to(x.dtype)
    y = rmsnorm(y * silu(z), p["norm"])  # gated RMSNorm (mamba2)
    out = dot(y, p["out_proj"])
    if return_cache:
        return out, {"state": final_state, "conv": xbc_raw[:, -(w - 1):].float()}
    return out


# ---------------------------------------------------------------------------
# Decode (O(1) per token)
# ---------------------------------------------------------------------------


def ssd_init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    return {
        "state": torch.zeros((batch, h, hd, n), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, di + 2 * n), dtype=dtype,
                            device=device),
    }


def ssd_decode(x: torch.Tensor, p: dict, cfg: ModelConfig, cache: dict,
               out: Optional[dict] = None):
    """x: (B, 1, d) -> (y, cache'): the new state and conv tail written
    into ``out`` (default: ``cache`` itself, in place) and returned."""
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    out = cache if out is None else out
    z, xr, b, c, dt = _split_proj(dot(x, p["in_proj"]), cfg)
    win, conv_out = conv_step(cache["conv"], torch.cat([xr, b, c], -1), p["conv_w"],
                              p["conv_b"])
    xr, b, c = torch.split(silu(conv_out), [di, n, n], -1)  # (B, .)

    dt = F.softplus(dt.float() + p["dt_bias"].float())[:, 0]  # (B,H)
    a = -torch.exp(p["a_log"].float())
    da = torch.exp(dt * a[None, :])  # (B,H)
    xh = xr.reshape(-1, h, hd).float()
    bx = (xh * dt[..., None])[..., None] * b.float()[:, None, None, :]  # (B,H,P,N)
    state = torch.mul(cache["state"], da[:, :, None, None], out=out["state"]).add_(bx)
    y = torch.matmul(state, c.float()[:, None, :, None])[..., 0]  # (B,H,P)
    y = y + xh * p["d_skip"].float()[None, :, None]
    y = y.reshape(-1, 1, di).to(x.dtype)
    y = rmsnorm(y * silu(z), p["norm"])
    out["conv"].copy_(win[:, 1:])
    return dot(y, p["out_proj"]), out
