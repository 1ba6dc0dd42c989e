"""Shared building blocks of the backbones and a tiny param-schema system
(PyTorch counterpart of ``repro/models/layers.py``).

Params are plain nested dicts of tensors.  Every leaf is declared once via
``Leaf(shape, axes, init)``; ``init_params`` materializes a schema,
``count_params`` counts it, ``abstract_params`` gives its shapes on the
meta device, and ``param_specs`` its layout on the current mesh
(``distributed.sharding``), all from that one declaration.

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
from repro_torch.distributed import sharding
from repro_torch.launch import census

# ---------------------------------------------------------------------------
# Param schema
# ---------------------------------------------------------------------------


# Axes that stack copies of a weight (layers, experts): never contracted.
STACKED_AXES = ("layers", "experts")


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: tuple
    axes: tuple  # logical axis names, len == len(shape)
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'embed'
    scale: Optional[float] = None  # override fan-in scaling
    # The dims the weight contracts with at use, where they are not its
    # first non-stacked dim (attention's wo contracts heads x head_dim).
    fan_in: Optional[int] = None

    @property
    def std(self) -> Optional[float]:
        """The standard deviation of a drawn leaf (None: a constant leaf):
        ``scale`` where given, else 1/sqrt(fan-in), the fan-in being
        ``fan_in`` or the first dim outside ``STACKED_AXES``.  (The
        reference takes ``shape[0]``, which for a stacked leaf is the
        number of layers or experts.)"""
        if self.init in ("zeros", "ones"):
            return None
        if self.init == "embed":
            return 1.0
        if self.scale is not None:
            return self.scale
        dims = [n for n, ax in zip(self.shape, self.axes) if ax not in STACKED_AXES]
        fan_in = self.fan_in or (dims[0] if len(dims) > 1 else dims[-1])
        return 1.0 / float(np.sqrt(max(fan_in, 1)))

    def initializer(self, generator: Optional[torch.Generator], device, dtype) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        z = torch.randn(self.shape, generator=generator, dtype=torch.float32, device=device)
        # Scaled in place: one f32 copy of the leaf at a time (deepseek-moe-16b's
        # moe/wg is 20.7 GB in f32).
        return z.mul_(self.std).to(dtype)


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


_BIG = 1 << 20  # params above this get the ensure-model-sharded post-pass
_FSDP = 1 << 22  # params above this are additionally FSDP-sharded over data


def _leaf_spec(leaf: Leaf) -> sharding.PartitionSpec:
    """The leaf's layout under the current mesh, by the reference's rules:
    its logical axes resolved at its shape; past ``_BIG`` elements 'model'
    is put on a divisible dim if the axes gave it none, past ``_FSDP``
    'data' too (ZeRO-3).  An embedding table keeps its natural 'vocab'
    rule alone."""
    spec = sharding.resolve(*leaf.axes, shape=leaf.shape)
    if leaf.init == "embed":
        return spec
    n = int(np.prod(leaf.shape))
    if n >= _BIG:
        spec = sharding.ensure_axis_sharded(spec, leaf.shape, "model")
    if n >= _FSDP:
        spec = sharding.ensure_axis_sharded(spec, leaf.shape, "data")
    return spec


# The logical axes on whose dims a leaf keeps "model" where it is used in
# the partitioned training step: its q and kv heads, d_ff and vocabulary,
# and the experts of an expert-stacked weight (experts its leading dim).
TP_AXES = ("heads", "kv_heads", "mlp", "vocab", "experts")


def compute_spec(leaf: Leaf, spec: sharding.PartitionSpec) -> sharding.PartitionSpec:
    """The layout the partitioned training step uses ``leaf`` in, from the
    layout it is held in: "model" where ``spec`` puts it on one of
    ``TP_AXES``, every other dim whole (gathered before use: the FSDP "data"
    dims, and "model" where the ``_BIG`` post-pass moved it to another
    dim).  "experts" keeps "model" only as an expert-stacked weight's
    leading dim, where the expert-parallel block runs a position's block of
    the experts; the router, whose experts are its output dim, is used
    whole, as the reference's EP block takes it."""
    entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
    return sharding.PartitionSpec(*(
        e if e == "model" and ax in TP_AXES and (ax != "experts" or i == 0) else None
        for i, (e, ax) in enumerate(zip(entries, leaf.axes))))


def model_split(spec, dim: int) -> bool:
    """Whether ``spec`` splits dim ``dim`` over "model" alone."""
    return len(spec) > dim and spec[dim] == "model"


def _tree_of(schema, fn) -> dict:
    out: dict = {}
    for path, leaf in _iter_leaves(schema):
        sub = out
        for k in path[:-1]:
            sub = sub.setdefault(k, {})
        sub[path[-1]] = fn(leaf)
    return out


def param_specs(schema) -> dict:
    """A ``PartitionSpec`` per leaf under the current mesh, in the schema's
    structure."""
    return _tree_of(schema, _leaf_spec)


def abstract_params(schema, dtype: torch.dtype = torch.float32):
    """(meta-device tensors of the schema's shapes in ``dtype``, and under
    a mesh the matching tree of ``Placement``s, else None): the leaves'
    shapes and layouts with nothing allocated."""
    params = _tree_of(schema, lambda leaf: torch.empty(leaf.shape, dtype=dtype, device="meta"))
    mesh = sharding.mesh_or_none()
    if mesh is None:
        return params, None
    return params, _tree_of(schema, lambda leaf: sharding.Placement(mesh, _leaf_spec(leaf)))


def stack_schema(schema, n: int, axis_name: str = "layers"):
    """Add a leading stacked-layers dim to every leaf."""
    if isinstance(schema, Leaf):
        return Leaf(
            shape=(n,) + schema.shape,
            axes=(axis_name,) + schema.axes,
            init=schema.init,
            scale=schema.scale,
            fan_in=schema.fan_in,
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


def dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ cast(w) (batched where both are 3-D) in the promoted dtype, as
    jnp promotes an f32 activation against a bf16 weight: the stored
    weight is never widened, only its bf16 copy at the product."""
    w = cast(w)
    dt = torch.promote_types(a.dtype, w.dtype)
    return torch.matmul(a.to(dt), w.to(dt))


def silu(a: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu's steps, each rounded in a's dtype: a * (1 / (1 +
    exp(-a))).  (``F.silu`` rounds once, and in bf16 a third of its values
    land one ulp from the reference's.)"""
    return a * (1.0 / (1.0 + torch.exp(-a)))


def swiglu(x, wg, wu, wd):
    """LLaMA-style gated MLP.  x: (..., d); wg/wu: (d, ff); wd: (ff, d)."""
    h = F.silu(x @ cast(wg)) * (x @ cast(wu))
    return h @ cast(wd)


def swiglu_tp(x: dict, wg: dict, wu: dict, wd: dict, mesh, split: bool, fn=swiglu) -> dict:
    """``fn`` (``swiglu``, or another gated MLP of the same weights) per mesh
    position on its slices: with ``split``, wg and wu column-parallel on the
    position's block of d_ff and wd row-parallel on it, the partial products
    summed over "model" in axis order (the gate is elementwise over d_ff, so
    a block of it needs only its own columns); else each position's weights
    whole and nothing reduced (or the caller reduces the partial products
    later: ``moe.moe_block_tp``)."""
    y = {pos: fn(x[pos], wg[pos], wu[pos], wd[pos]) for pos in x}
    return sharding.all_reduce(y, mesh, "model") if split else y


def gelu_mlp(x, wi, wo):
    h = F.gelu(x @ cast(wi), approximate="tanh")
    return h @ cast(wo)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _rope_frequencies(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    with census.uncounted():
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
    return torch.mean(cross_entropy_rows(logits, labels))


def cross_entropy_rows(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (..., V); labels (...) int -> each row's loss (...) in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - ll


# ---------------------------------------------------------------------------
# Vocab-parallel embedding and cross-entropy (the partitioned training step)
# ---------------------------------------------------------------------------


def _vocab_block(labels: torch.Tensor, lo: int, n: int):
    """(labels as indices into the rows [lo, lo + n) of the vocabulary, 0
    where outside, and the mask of those inside)."""
    local = labels.long() - lo
    inside = (local >= 0) & (local < n)
    return torch.where(inside, local, 0), inside


def vocab_parallel_embed(tokens: dict, table: dict, mesh, split: bool) -> dict:
    """The embedding lookup per mesh position, ``cast(table)[tokens]``.  With
    ``split``, a position holds the rows of its block of the vocabulary
    (its index along "model"): it looks up the tokens in it, zeroes the
    others, and the blocks' partial rows are summed over "model" (one of
    them is not zero: the sum is exact)."""
    if not split:
        return {pos: cast(table[pos])[tokens[pos].long()] for pos in tokens}
    mi = mesh.axis_names.index("model")
    out = {}
    for pos, t in table.items():
        idx, inside = _vocab_block(tokens[pos], pos[mi] * t.shape[0], t.shape[0])
        out[pos] = torch.where(inside[..., None], cast(t)[idx], 0)
    return sharding.all_reduce(out, mesh, "model")


def vocab_parallel_cross_entropy(logits: dict, labels: dict, mesh, split: bool) -> dict:
    """Each row's loss per mesh position, ``cross_entropy_rows``.  With
    ``split``, a position holds its block of the vocabulary's logits: the
    row max (no gradient, as the max of ``logsumexp``'s shift has none), the
    sum of the exponentials past it and the target's logit (0 where the
    target is in another block) are each reduced over "model", and every
    position of a data row ends with the same losses."""
    if not split:
        return {pos: cross_entropy_rows(logits[pos], labels[pos]) for pos in logits}
    mi = mesh.axis_names.index("model")
    f32 = {pos: x.float() for pos, x in logits.items()}
    top = sharding.all_reduce({pos: x.detach().amax(-1) for pos, x in f32.items()}, mesh,
                              "model", op="max")
    sums = sharding.all_reduce({pos: torch.exp(x - top[pos][..., None]).sum(-1)
                                for pos, x in f32.items()}, mesh, "model")
    target = {}
    for pos, x in f32.items():
        idx, inside = _vocab_block(labels[pos], pos[mi] * x.shape[-1], x.shape[-1])
        target[pos] = torch.where(inside, torch.gather(x, -1, idx[..., None])[..., 0], 0)
    target = sharding.all_reduce(target, mesh, "model")
    return {pos: top[pos] + torch.log(sums[pos]) - target[pos] for pos in logits}

