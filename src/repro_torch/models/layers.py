"""Shared building blocks of the backbones and a tiny param-schema system
(PyTorch counterpart of ``repro/models/layers.py``).

Params are plain nested dicts of tensors.  Every leaf is declared once via
``Leaf(shape, axes, init)``; ``init_params`` materializes a schema, and
``count_params`` counts it, from that one declaration.

Numerics follow the reference: activations in bf16 (``COMPUTE_DTYPE``),
norms computed in f32 on f32 weights, rotary embeddings in f32.  A serving
model keeps its matmul weights in bf16 from the start (``serving_dtype``):
the reference casts them at every use, and ``cast`` of a weight that
serving never updates gives the same bf16 each time.
"""

from __future__ import annotations

import dataclasses
import functools
import zlib
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device

# ---------------------------------------------------------------------------
# Param schema
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: tuple
    axes: tuple  # logical axis names, len == len(shape)
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'embed'
    scale: Optional[float] = None  # override fan-in scaling

    @property
    def std(self) -> Optional[float]:
        """The standard deviation of a drawn leaf (None: a constant leaf)."""
        if self.init in ("zeros", "ones"):
            return None
        if self.init == "embed":
            return 1.0
        fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
        return self.scale if self.scale is not None else 1.0 / float(np.sqrt(max(fan_in, 1)))

    def initializer(self, generator: Optional[torch.Generator], device, dtype) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        z = torch.randn(self.shape, generator=generator, dtype=torch.float32, device=device)
        return (z * self.std).to(dtype)


def _iter_leaves(schema, path=()):
    if isinstance(schema, Leaf):
        yield path, schema
        return
    for k, v in schema.items():
        yield from _iter_leaves(v, path + (k,))


def leaf_seed(seed: int, path: tuple) -> int:
    """A leaf's generator seed: the run's seed mixed with a CRC of the leaf's
    path.  Stable across processes (the reference mixes in the salted
    ``hash()``, which differs from process to process)."""
    crc = zlib.crc32("/".join(map(str, path)).encode())
    return ((int(seed) & 0x7FFFFFFF) << 32) | crc


def serving_dtype(leaf: Leaf) -> torch.dtype:
    """bf16 for a matmul or embedding weight, f32 for a norm weight."""
    return torch.float32 if leaf.init in ("zeros", "ones") else COMPUTE_DTYPE


def init_params(
    schema,
    seed: int = 0,
    device: str | torch.device | None = None,
    dtype: Union[torch.dtype, Callable[[Leaf], torch.dtype]] = torch.float32,
) -> dict:
    """Materialize a schema into tensors on ``device`` (CUDA unless named),
    each leaf drawn in f32 from its own generator (``leaf_seed``) on that
    device, then cast to ``dtype`` (a dtype, or a function of the leaf such
    as ``serving_dtype``)."""
    device = resolve_device(device)
    out: dict = {}
    for path, leaf in _iter_leaves(schema):
        sub = out
        for k in path[:-1]:
            sub = sub.setdefault(k, {})
        gen = None
        if leaf.std is not None:
            gen = torch.Generator(device=device)
            gen.manual_seed(leaf_seed(seed, path))
        dt = dtype(leaf) if callable(dtype) else dtype
        sub[path[-1]] = leaf.initializer(gen, device, dt)
    return out


def stack_schema(schema, n: int, axis_name: str = "layers"):
    """Add a leading stacked-layers dim to every leaf."""
    if isinstance(schema, Leaf):
        return Leaf(
            shape=(n,) + schema.shape,
            axes=(axis_name,) + schema.axes,
            init=schema.init,
            scale=schema.scale,
        )
    return {k: stack_schema(v, n, axis_name) for k, v in schema.items()}


def count_params(schema) -> int:
    return sum(int(np.prod(leaf.shape)) for _, leaf in _iter_leaves(schema))


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

COMPUTE_DTYPE = torch.bfloat16


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, -1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, -1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def swiglu(x, wg, wu, wd):
    """LLaMA-style gated MLP.  x: (..., d); wg/wu: (d, ff); wd: (ff, d)."""
    h = F.silu(x @ cast(wg)) * (x @ cast(wu))
    return h @ cast(wd)


def gelu_mlp(x, wi, wo):
    h = F.gelu(x @ cast(wi), approximate="tanh")
    return h @ cast(wo)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _rope_frequencies(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """1 / theta^(2i/hd) in f32, made once per (head_dim, theta, device): a
    decode step asks for it twice a layer, and the cached tensor is only
    read."""
    return _rope_frequencies(head_dim, float(theta), torch.device(device or "cpu"))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (B, S, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def sinusoidal_embedding(n_pos: int, dim: int, device: str | torch.device | None = None) -> torch.Tensor:
    pos = np.arange(n_pos)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / dim)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(emb, dtype=torch.float32, device=resolve_device(device))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (..., V); labels (...) int -> mean loss (f32)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)

