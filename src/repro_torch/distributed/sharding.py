"""Logical-axis sharding: which mesh entries hold which slice of a tensor
(PyTorch counterpart of ``repro/distributed/sharding.py``).

Models name tensor axes logically ("batch", "heads", "experts", ...); a rule
table maps those names to mesh axes.  The rule table is the reference's,
copied whole, so rule overrides written for it carry over.

The JAX package is single-controller: GSPMD places arrays and ``shard_map``
runs one function per device with collectives inside it.  One torch
process has no partitioner, so here placement and exchange are explicit:

* a ``Mesh`` is a grid of ``torch.device`` entries in this process, with
  axis names and sizes (``("fleet",)`` of N entries, or ``("data",
  "model")``), and entries may repeat (``["cuda:0"] * 8`` runs a (2, 4)
  mesh on one card, ``["cpu"] * 8`` on a CPU host, as the JAX package's
  forced host device count does);
* ``resolve`` gives a ``PartitionSpec`` by the reference's rules, and a
  ``Placement`` (mesh, spec) says which slice of a leaf each mesh position
  holds, as ``NamedSharding.devices_indices_map`` does; ``Placement.place``
  cuts a tensor into those slices, each on its entry (a ``Sharded``), and
  ``Sharded.gather`` puts the whole tensor back together;
* a collective is a tensor moved between entries (``exchange``: a
  ``.to(device)``, then ``cat`` or ``split``): a peer copy between two
  cards, a device-local copy (or none) where two entries name one device.
  ``exchange`` also tallies the move into an open ``launch.census`` when
  the two positions differ, whatever their devices.  ``all_gather``,
  ``reduce_scatter``, ``all_reduce`` and ``broadcast`` over one mesh axis
  are built on it, on dicts of per-position tensors, and ``relayout``
  gathers slices into a coarser layout.

One process calls the shards one after another, so a shard cannot wait
inside a collective for another: there is no generic ``shard_map`` here.
Each region the reference writes under ``shard_map`` is written as phases
with the exchanges between them (``models.moe.moe_block_ep``,
``distributed.pipeline.pipeline_forward``), and so is the training step
GSPMD partitions for the reference (``models.model.partitioned_train_step``).
``constrain`` is the identity on values, as ``constrain_fleet`` is: nothing
here re-lays a tensor out behind the caller's back.

The fleet's stream axis uses the same scope: ``activate(mesh)`` makes a
mesh current, ``deactivate()`` hides it again for shard-local regions,
``fleet_axis_size()`` says how many shards the ``stream`` rule splits a
fleet into (the ``fleet`` axis of a 1-D mesh, ``data`` of a (data, model)
mesh) and ``fleet_devices()`` which entry holds each (entry (k, 0, ...)).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import math
import threading
from typing import Optional

import torch

from repro_torch.launch import census as _census

_state = threading.local()

DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "stream": ("fleet", "pod", "data"),
    "seq": None,
    "seq_sp": "model",  # sequence-parallel regions (hillclimb variant)
    "seq_kv": "model",  # decode KV/latent cache length (flash-decoding style)
    "seq_attn": None,  # q rows in attention (enabled when heads don't divide)
    "embed": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_cap": None,
    "ssm_heads": "model",
    "ssm_state": None,
    "elm_hidden": None,
    "elm_out": None,
    "classes": None,
    "layers": None,
    "frames": None,
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of devices: ``devices`` in row-major order over axes
    ``axis_names`` of ``sizes`` (default: one axis of every device).
    Entries may repeat a device (``[cuda:0] * 4`` runs four shards on one
    card)."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("fleet",)
    sizes: Optional[tuple[int, ...]] = None

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        sizes = (len(self.devices),) if self.sizes is None else tuple(self.sizes)
        object.__setattr__(self, "sizes", sizes)
        if len(sizes) != len(self.axis_names) or math.prod(sizes) != len(self.devices):
            raise ValueError(f"a mesh of axes {self.axis_names} sized {sizes} cannot hold "
                             f"{len(self.devices)} devices")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape`` gives it."""
        return dict(zip(self.axis_names, self.sizes))

    def positions(self):
        """Every mesh position (a tuple of one index per axis), row-major."""
        return itertools.product(*(range(n) for n in self.sizes))

    def device_at(self, pos: tuple) -> torch.device:
        flat = 0
        for i, n in zip(pos, self.sizes):
            flat = flat * n + i
        return self.devices[flat]


# The 1-D mesh a fleet's stream axis splits over: a ``Mesh`` of one axis.
FleetMesh = Mesh


class PartitionSpec(tuple):
    """A tensor's layout on a mesh, one entry per dim: None (every position
    holds the whole dim), a mesh axis name, or a tuple of names (the dim
    split over the product of their sizes, the first axis major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axes_of(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class Placement:
    """``spec`` on ``mesh``: the port's ``NamedSharding``."""

    mesh: Mesh
    spec: PartitionSpec

    def indices_map(self, shape: tuple) -> dict:
        """Mesh position -> the slices (one per dim) of a ``shape`` tensor it
        holds, as ``NamedSharding.devices_indices_map`` keys them by device.
        A dim the spec splits must divide by its shard count."""
        entries = list(self.spec) + [None] * (len(shape) - len(self.spec))
        sizes = self.mesh.shape
        out = {}
        for pos in self.mesh.positions():
            coord = dict(zip(self.mesh.axis_names, pos))
            index = []
            for dim, entry in zip(shape, entries):
                k, n = 0, 1
                for a in axes_of(entry):
                    k, n = k * sizes[a] + coord[a], n * sizes[a]
                if n == 1:
                    index.append(slice(None))
                    continue
                if dim % n:
                    raise ValueError(f"dim {dim} does not split {n} ways ({self.spec})")
                index.append(slice(k * (dim // n), (k + 1) * (dim // n)))
            out[pos] = tuple(index)
        return out

    def place(self, tensor) -> "Sharded":
        """``tensor`` (or a numpy array) cut into the slice each position
        holds, each a copy on the position's entry."""
        tensor = torch.as_tensor(tensor)
        shards = {pos: tensor[index].to(self.mesh.device_at(pos), copy=True)
                  for pos, index in self.indices_map(tuple(tensor.shape)).items()}
        return Sharded(self, tuple(tensor.shape), shards)


@dataclasses.dataclass
class Sharded:
    """A tensor laid out by ``placement``: ``shards[pos]`` is the slice
    mesh position ``pos`` holds, on that position's entry."""

    placement: Placement
    shape: tuple
    shards: dict

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first entry's)."""
        first = next(iter(self.shards.values()))
        device = torch.device(device) if device is not None else first.device
        out = torch.empty(self.shape, dtype=first.dtype, device=device)
        written = set()
        for pos, index in self.placement.indices_map(self.shape).items():
            key = tuple((s.start, s.stop) for s in index)
            if key not in written:
                out[index] = self.shards[pos].to(device)
                written.add(key)
        return out


def exchange(t: torch.Tensor, src: tuple, dst: tuple, mesh: Mesh,
             kind: str = "all-to-all", back_kind: Optional[str] = None) -> torch.Tensor:
    """``t``, held by mesh position ``src``, moved to position ``dst``'s
    entry: ``t.to(device)``.  Under an open census a move between two
    positions counts as one exchange of ``kind`` with t's bytes, and its
    gradient's move back as one of ``back_kind`` (default ``kind``);
    without one, or from a position to itself, it is the plain ``.to``."""
    out = t.to(mesh.device_at(dst))
    c = _census.active()
    if c is None or src == dst:
        return out
    c.add_exchange(kind, t.numel() * t.element_size())
    if out.requires_grad:
        if out is t:  # the same device: a node of its own for the gradient's hook
            out = t.view_as(t)
        back = back_kind or kind
        out.register_hook(lambda g: c.add_exchange(back, g.numel() * g.element_size()))
    return out


# ---------------------------------------------------------------------------
# Collectives over one mesh axis, on per-position tensors
# ---------------------------------------------------------------------------
#
# A partitioned tensor in flight is a dict {mesh position: the tensor that
# position holds}.  Each collective below is built from ``exchange``: every
# receiving position takes its peers' tensors along ``axis`` (the positions
# that differ from it on that axis alone), and concatenates or reduces them
# in axis order, so every receiver of one result holds the same bits.
# Autograd runs through the moves: the gradient of an all-gather goes back
# to the shards, summed there by autograd (the reduce-scatter, tallied so),
# and that of a reduce-scatter comes back as an all-gather.


def peers(pos: tuple, mesh: Mesh, axis: str) -> list:
    """The positions along ``axis`` through ``pos``, in axis order."""
    i = mesh.axis_names.index(axis)
    return [pos[:i] + (k,) + pos[i + 1:] for k in range(mesh.sizes[i])]


def all_gather(parts: dict, mesh: Mesh, axis: str, dim: int) -> dict:
    """Each position: its peers' parts along ``axis`` concatenated on
    ``dim`` in axis order (tallied ``all-gather``; the gradient's way back
    ``reduce-scatter``)."""
    return {pos: torch.cat([exchange(parts[q], q, pos, mesh, "all-gather", "reduce-scatter")
                            for q in peers(pos, mesh, axis)], dim)
            for pos in parts}


def reduce_scatter(parts: dict, mesh: Mesh, axis: str, dim: int) -> dict:
    """Each position at index k of ``axis``: the sum, in axis order, of block
    k along ``dim`` of its peers' parts (the blocks equal, ``dim`` split as
    many ways as the axis is long; tallied ``reduce-scatter``)."""
    n = mesh.shape[axis]
    i = mesh.axis_names.index(axis)
    out = {}
    for pos in parts:
        blocks = [exchange(parts[q].chunk(n, dim)[pos[i]], q, pos, mesh, "reduce-scatter",
                           "all-gather") for q in peers(pos, mesh, axis)]
        out[pos] = functools.reduce(torch.add, blocks)
    return out


def all_reduce(parts: dict, mesh: Mesh, axis: str, op: str = "sum") -> dict:
    """Each position: its peers' parts along ``axis`` reduced by ``op``
    ("sum" or "max") in axis order (tallied ``all-reduce``)."""
    fn = {"sum": torch.add, "max": torch.maximum}[op]
    return {pos: functools.reduce(fn, [exchange(parts[q], q, pos, mesh, "all-reduce")
                                       for q in peers(pos, mesh, axis)])
            for pos in parts}


def broadcast(parts: dict, mesh: Mesh, axis: str, root: int = 0) -> dict:
    """Each position: the part of its peer at index ``root`` of ``axis``
    (tallied ``broadcast``; the gradients' way back ``reduce``, summed at
    the root by autograd)."""
    i = mesh.axis_names.index(axis)
    return {pos: exchange(parts[pos[:i] + (root,) + pos[i + 1:]], pos[:i] + (root,) + pos[i + 1:],
                          pos, mesh, "broadcast", "reduce")
            for pos in parts}


def relayout(parts: dict, spec_from: PartitionSpec, spec_to: PartitionSpec, mesh: Mesh) -> dict:
    """Per-position slices laid out by ``spec_from`` -> the slices
    ``spec_to`` gives each position, where ``spec_to`` keeps some of
    ``spec_from``'s entries and drops the others to None: every dropped
    entry's axes are all-gathered on its dim, the minor axis first."""
    n = max(len(spec_from), len(spec_to))
    src = list(spec_from) + [None] * (n - len(spec_from))
    dst = list(spec_to) + [None] * (n - len(spec_to))
    for dim, (a, b) in enumerate(zip(src, dst)):
        if a == b:
            continue
        if b is not None:
            raise ValueError(f"relayout {spec_from} -> {spec_to}: dim {dim} is not dropped")
        for axis in reversed(axes_of(a)):
            parts = all_gather(parts, mesh, axis, dim)
    return parts


def _current() -> tuple[Optional[Mesh], dict]:
    return getattr(_state, "mesh", None), getattr(_state, "rules", DEFAULT_RULES)


def scope() -> tuple[Optional[Mesh], dict]:
    """The current scope, (mesh or None, rules), for ``within``."""
    return _current()


@contextlib.contextmanager
def within(captured: tuple[Optional[Mesh], dict]):
    """Run the code under this scope in a scope ``scope()`` captured, on
    any thread (the scope is thread-local: on the card autograd runs the
    backward, and remat's recomputation in it, on a thread of its own); the
    previous scope comes back on exit, also on an exception."""
    prev = _current()
    _state.mesh, _state.rules = captured
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def activate(mesh: Mesh, rules: Optional[dict] = None):
    """Make ``mesh`` (and ``rules`` over the defaults) current for the code
    under this scope."""
    return within((mesh, dict(DEFAULT_RULES, **(rules or {}))))


def deactivate():
    """Hide the current mesh inside an ``activate`` scope, for shard-local
    regions (a sharded stream session's per-shard calls, each on one
    device): under it ``mesh_or_none()`` is None and ``fleet_axis_size()``
    is 1."""
    return within((None, DEFAULT_RULES))


def mesh_or_none() -> Optional[Mesh]:
    return _current()[0]


def resolve(*logical_axes: Optional[str], shape: Optional[tuple] = None) -> PartitionSpec:
    """Logical axis names -> PartitionSpec under the current rules.

    Rules that name mesh axes absent from the current mesh degrade to
    replication (so the same model runs on a 2-axis or 3-axis mesh), and a
    mesh axis serves one dim at most.  When ``shape`` is given, mesh axes
    that do not divide the dim are dropped (greedy prefix for multi-axis
    rules): batch=1 stays replicated, 56 heads on a 16-way model axis fall
    back to replication (and ``layers.param_specs`` reassigns 'model' to a
    divisible dim)."""
    mesh, rules = _current()
    sizes = mesh.shape if mesh is not None else {}
    spec, used = [], set()
    for i, name in enumerate(logical_axes):
        target = rules.get(name, None) if name is not None else None
        if target is None:
            spec.append(None)
            continue
        parts = tuple(p for p in axes_of(target) if p in sizes and p not in used)
        if shape is not None:
            kept, prod = [], 1
            for p in parts:  # greedy prefix that divides the dim
                if shape[i] % (prod * sizes[p]) == 0:
                    kept.append(p)
                    prod *= sizes[p]
            parts = tuple(kept)
        used.update(parts)
        spec.append(None if not parts else parts[0] if len(parts) == 1 else parts)
    return PartitionSpec(*spec)


def constrain(x, *logical_axes: Optional[str]):
    """The identity: the reference asks GSPMD to lay ``x`` out by these
    names; here each region places its tensors itself."""
    return x


def named_sharding(*logical_axes: Optional[str],
                   shape: Optional[tuple] = None) -> Optional[Placement]:
    """The ``Placement`` of these logical axes under the current mesh
    (None with no mesh)."""
    mesh, _ = _current()
    if mesh is None:
        return None
    return Placement(mesh, resolve(*logical_axes, shape=shape))


def ensure_axis_sharded(spec: PartitionSpec, shape: tuple, axis: str) -> PartitionSpec:
    """Schema post-pass: put mesh axis ``axis`` on the largest unsharded dim
    it divides, if the spec does not use it yet (the reference's: 'model'
    for archs whose natural TP axis does not divide the model axis, 'data'
    for FSDP/ZeRO-3 sharding of large params)."""
    mesh, _ = _current()
    if mesh is None or axis not in mesh.axis_names:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if any(axis in axes_of(e) for e in entries):
        return spec
    size = mesh.shape[axis]
    cands = [(shape[i], i) for i, e in enumerate(entries)
             if e is None and shape[i] % size == 0 and shape[i] >= size]
    if not cands:
        return spec
    _, idx = max(cands)
    entries[idx] = axis
    return PartitionSpec(*entries)


def ensure_model_sharded(spec: PartitionSpec, shape: tuple) -> PartitionSpec:
    return ensure_axis_sharded(spec, shape, "model")


def _stream_axes() -> tuple:
    mesh, rules = _current()
    target = rules.get("stream", None)
    return tuple(a for a in axes_of(target) if a in mesh.shape)


def fleet_axis_size() -> int:
    """Number of shards the ``stream`` rule resolves to under the current
    mesh: the product of the sizes of the mesh axes it names.  1 with no
    mesh current; callers size the stream-axis padding with it."""
    mesh, _ = _current()
    if mesh is None:
        return 1
    return math.prod(mesh.shape[a] for a in _stream_axes())


def fleet_devices() -> Optional[list]:
    """The entry that holds each stream shard under the current mesh, shard
    order: the positions along the ``stream`` rule's axes, every other axis
    at 0 (shard k of a (data, model) mesh on entry (k, 0)).  None with no
    mesh."""
    mesh, _ = _current()
    if mesh is None:
        return None
    axes = _stream_axes()
    out = []
    for idx in itertools.product(*(range(mesh.shape[a]) for a in axes)):
        coord = dict(zip(axes, idx))
        out.append(mesh.device_at(tuple(coord.get(a, 0) for a in mesh.axis_names)))
    return out


def constrain_fleet(tree):
    """The identity: the reference constrains a fleet's leading axis to the
    ``stream`` rule for GSPMD; here the shard paths place rows explicitly."""
    return tree


def fleet_sharding(leaf_ndim: int, shape: Optional[tuple] = None) -> Optional[Placement]:
    """The ``Placement`` of a fleet leaf's leading axis on the stream rule
    (None with no mesh)."""
    return named_sharding("stream", *((None,) * (leaf_ndim - 1)), shape=shape)
