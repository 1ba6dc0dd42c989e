"""The census of one step's work, counted from the step itself (PyTorch
counterpart of ``repro/launch/hlo_census.py``).

The JAX package compiles a step and reads its optimized HLO: XLA's
``cost_analysis()`` for FLOPs and bytes, ``memory_analysis()`` for memory,
and the collective instructions for the exchanges.  The port has no HLO,
so ``StepCensus`` counts one call of a step as it runs, on any device: on
the meta device (nothing is computed or allocated, so a full-size cell
costs only the host's time), on the CPU or on the card.  It counts:

* **FLOPs**: matmul-class FLOPs by ``torch.utils.flop_counter``'s
  formulas (``FlopCounterMode``'s registry: products, convolutions and
  attention only: model FLOPs), applied by the census's own dispatch mode,
  which counts the bytes in the same pass (one Python mode per op, not two).  XLA's ``flops`` also counts elementwise ops, so the two are not
  compared.  Each entry point of ``kernels/ops`` adds ``ops.kernel_cost``
  for its shape; inside it the aten-level counting is paused, so the plain
  version (CPU), the meta route and the kernel (CUDA) count the same.
* **Bytes accessed**: the bytes of every input and output of each aten op
  (views count nothing), and the entry points' ``kernel_cost`` bytes: the
  unfused count, in the sense of XLA's "bytes accessed".
* **Exchanges**: the explicit moves between mesh positions that
  ``sharding.exchange`` makes (the EP block's dispatch and return, the
  pipeline's hand-offs), forward and backward, by kind; ``collective_census``
  gives them in the reference's structure.
* **Live bytes**: the peak, during the call, of the bytes held by the op
  outputs made in it that are still alive (each output is an allocation
  from its op until its last reference dies; views and in-place results
  allocate nothing).  The call's arguments are not in it: it is XLA's
  ``temp_size_in_bytes`` counterpart.

The census is module-global, not per thread: on the card autograd runs the
backward on a thread of its own, and the dispatch modes follow it there.
"""

from __future__ import annotations

import contextlib
import math
import threading
import weakref
from typing import Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

_lock = threading.Lock()
_stack: list["StepCensus"] = []


def active() -> Optional["StepCensus"]:
    """The census open now, or None."""
    return _stack[-1] if _stack else None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _Tally(TorchDispatchMode):
    """FLOPs of every product, bytes of every non-view aten op's inputs and
    outputs, and each fresh output's allocation for the live count."""

    def __init__(self, census: "StepCensus"):
        from torch.utils.flop_counter import flop_registry

        super().__init__()
        self.census = census
        self.flop_registry = flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        count = self.flop_registry.get(func._overloadpacket)
        flops = 0 if count is None else int(count(*args, **kwargs, out_val=out))
        if flops:
            self.census._add_flops(flops)
        rets = func._schema.returns
        outs = (out,) if len(rets) == 1 else out if rets else ()
        inputs = _tensors((args, kwargs))
        self.census._note_reads(inputs)
        moved = sum(_nbytes(t) for t in inputs)
        for ret, o in zip(rets, outs):
            for t in _tensors(o):
                moved += _nbytes(t)
                if ret.alias_info is None:  # not in place, not out=: a new allocation
                    self.census._alloc(t)
        self.census._add_bytes(moved)
        if self.census.trace is not None:
            self.census.trace.append((str(func), flops, moved))
        return out


class StepCensus:
    """Context manager over one call of a step: ``flops``,
    ``bytes_accessed``, ``peak_live_bytes`` and the exchanges
    (``collective_census(census)``).  Censuses do not nest."""

    def __init__(self, watch=(), trace: bool = False):
        """``watch``: tensors (a step's arguments) whose use the census
        notes in ``used``: the indices of those an op or entry point read
        or wrote (``jax.jit`` drops the arguments a step never uses).
        ``trace``: keep (op or entry point, FLOPs, bytes) of every call in
        ``trace``, to find where two censuses part."""
        self.trace: Optional[list] = [] if trace else None
        self._watch = {t.untyped_storage()._cdata: i for i, t in enumerate(watch)}
        self.used: set[int] = set()
        self.aten_flops = 0
        self.aten_bytes = 0
        self.kernel_flops = 0
        self.kernel_bytes = 0
        self.kernel_calls: dict[str, int] = {}
        self.exchanges: dict[str, dict] = {}
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._tally = None
        self._kernel_outputs: set[int] = set()

    # -- the counts ---------------------------------------------------------

    @property
    def flops(self) -> int:
        return self.aten_flops + self.kernel_flops

    @property
    def bytes_accessed(self) -> int:
        return self.aten_bytes + self.kernel_bytes

    # -- hooks --------------------------------------------------------------

    def _note_reads(self, tensors) -> None:
        if self._watch:
            for t in tensors:
                i = self._watch.get(t.untyped_storage()._cdata)
                if i is not None:
                    self.used.add(i)

    def _add_flops(self, n: int) -> None:
        with _lock:
            self.aten_flops += int(n)

    def _add_bytes(self, n: int) -> None:
        with _lock:
            self.aten_bytes += n

    def _alloc(self, t: torch.Tensor) -> None:
        n = t.untyped_storage().nbytes()
        with _lock:
            self.live_bytes += n
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        with _lock:
            self.live_bytes -= n

    def add_kernel(self, name: str, flops: float, nbytes: float, outputs, inputs) -> None:
        """One entry point's call: its cost, and its outputs that are not
        its inputs (or ``out=`` buffers) as allocations."""
        ins = _tensors(inputs)
        self._note_reads(ins)
        held = {t.untyped_storage()._cdata for t in ins}
        with _lock:
            self.kernel_flops += int(flops)
            self.kernel_bytes += int(nbytes)
            self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
            if self.trace is not None:
                self.trace.append((name, int(flops), int(nbytes)))
        for t in _tensors(outputs):
            base = t if t._base is None else t._base
            if base.untyped_storage()._cdata in held or id(base) in self._kernel_outputs:
                continue
            self._kernel_outputs.add(id(base))
            weakref.finalize(base, self._kernel_outputs.discard, id(base))
            self._alloc(base)

    def add_exchange(self, kind: str, nbytes: int) -> None:
        with _lock:
            e = self.exchanges.setdefault(kind, {"count": 0, "bytes": 0})
            e["count"] += 1
            e["bytes"] += int(nbytes)

    # -- the context --------------------------------------------------------

    def __enter__(self) -> "StepCensus":
        if _stack:
            raise RuntimeError("a census is open already; censuses do not nest")
        self._tally = _Tally(self)
        self._tally.__enter__()
        _stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _stack.remove(self)
        self._tally.__exit__(*exc)


@contextlib.contextmanager
def kernel_call():
    """The body of a kernel entry point: yields the open census (None
    without one) with its aten-level counting paused, so that the entry
    point adds its own cost (``StepCensus.add_kernel``) instead."""
    c = active()
    if c is None:
        yield None
        return
    with _disable_current_modes():
        yield c


@contextlib.contextmanager
def uncounted():
    """A cache's fill (a constant made once per process and then only
    read): not counted, so that a step's census does not depend on what
    ran before it in the process."""
    if active() is None:
        yield
        return
    with _disable_current_modes():
        yield


def collective_census(census: StepCensus) -> dict:
    """``{kind: {"count": int, "bytes": int}, "total_bytes": int}`` over
    the census's exchanges (the reference's structure; kinds
    ``all-to-all``, ``collective-permute``, and the collectives of
    ``distributed.sharding``: ``all-gather``, ``reduce-scatter``,
    ``all-reduce``, ``broadcast``, ``reduce`` and ``gather``).  A count is
    one tensor moved from one mesh position to another, its bytes the
    tensor's."""
    out = {kind: dict(v) for kind, v in census.exchanges.items()}
    out["total_bytes"] = sum(v["bytes"] for v in census.exchanges.values())
    return out


def _add(out: dict, kind: str, count: int, nbytes: int) -> None:
    """``count`` moves of ``nbytes`` each into ``out``, by kind."""
    if count:
        e = out.setdefault(kind, {"count": 0, "bytes": 0})
        e["count"] += count
        e["bytes"] += count * nbytes


def partitioned_train_exchanges(cfg, tcfg, mesh, batch: int, seq: int) -> dict:
    """The exchanges of one ``model.partitioned_train_step`` of ``cfg`` under
    ``tcfg`` on the (data, model) ``mesh`` at ``batch`` x ``seq`` tokens,
    counted from the leaves' layouts (``model.abstract_train_state``), in
    ``collective_census``'s structure.  With P positions, a collective over
    an axis of n positions moves n - 1 tensors into each of the P:

    * each leaf's gathers before use (a stacked leaf's per layer, again in
      remat's recompute): ``all-gather`` forward, ``reduce-scatter`` back;
    * the embedding's and each layer's two reductions over "model" of the
      residual stream (``all-reduce``), forward and back at every
      position, each layer's first again in remat's recompute (which stops
      before the layer's last); the cross-entropy's three (the head splits
      the vocabulary over "model": other layouts raise): forward at every
      position, back only the sum and the target logit, and only at the
      home positions (the other positions' copies of a row's loss do not
      reach the loss);
    * an MoE layer's (``moe.moe_block_tp``, at the token shards and
      capacity ``moe.ep_layout`` and ``cfg.moe_impl`` give): the dispatch
      and return moves to and from the experts' homes (``all-to-all``,
      forward, again in remat's recompute, and back), the row's y
      all-gathered over "model" where the tokens split over it (and its
      ``reduce-scatter`` back), under ``"dense"`` each shard's per-expert
      pair counts to every other position (``all-gather`` of E int32,
      forward and in the recompute), and each token shard's aux (a 0-d f32)
      to the first entry (``gather``, and back); the shared experts'
      reduction is counted with the residual stream's;
    * each home position's row losses (and their gradients back) and
      pooled features to the first entry (``gather``);
    * all of the above once a microbatch; then once a step, each gradient's
      reduce-scatter into its moments' added split and all-reduce over the
      axes neither splits, the global norm's all-reduce over each axis, and
      the updated slices' all-gather back (f32 gradients, the params'
      dtype for the gather)."""
    from repro_torch.distributed import sharding
    from repro_torch.models import layers, model, transformer

    d, m = mesh.shape["data"], mesh.shape["model"]
    n_pos = d * m
    with sharding.activate(mesh):
        _, pl = model.abstract_train_state(cfg, tcfg)
    psize = torch.empty((), dtype=getattr(torch, tcfg.param_dtype)).element_size()
    rows = batch // (tcfg.microbatches * d)  # a position's rows a microbatch
    stream = rows * seq * cfg.d_model * torch.empty((), dtype=layers.COMPUTE_DTYPE).element_size()
    loss_rows = rows * seq * 4
    per_mb, out = {}, {}

    def local(shape, spec):
        return [n // math.prod(mesh.shape[a] for a in sharding.axes_of(e))
                for n, e in zip(shape, _padded(spec, len(shape)))]

    def gathers(shape, held, used, into, times, back=None):
        """``sharding.relayout(held -> used)``'s all-gathers, ``times`` over."""
        cur = local(shape, held)
        for dim, (a, b) in enumerate(zip(_padded(held, len(shape)), _padded(used, len(shape)))):
            if a == b:
                continue
            for axis in reversed(sharding.axes_of(a)):
                n = mesh.shape[axis]
                _add(into, "all-gather", times * n_pos * (n - 1), math.prod(cur) * psize)
                if back is not None:
                    _add(back, "reduce-scatter", n_pos * (n - 1), math.prod(cur) * psize)
                cur[dim] *= n

    top, layer = model.train_layout(cfg, pl.params)
    if not transformer.vocab_split(cfg, top):
        # Each position's loss is then whole, and only the home positions'
        # last layers reach the loss: not counted here.
        raise NotImplementedError(f"{cfg.arch_id} on {mesh.shape}: the head does not split "
                                  "the vocabulary over 'model'")
    fwd_layers = 2 if tcfg.remat else 1
    for path, leaf in layers._iter_leaves(model.build_schema(cfg)):
        if path[0] == "layers":
            for _ in range(cfg.n_layers):
                gathers(leaf.shape[1:], *layer["/".join(path[1:])], per_mb, fwd_layers, per_mb)
        elif path[0] in top:
            gathers(leaf.shape, *top[path[0]], per_mb, 1, per_mb)
    ring = m - 1
    attn = transformer.heads_split(cfg, layer)
    per_layer = attn + transformer.ffn_split(cfg, layer)
    # The recompute ends before the layer's last reductions: it repeats the
    # attention's, which tensors the backward needs follow.
    recomputed = attn if tcfg.remat else 0
    reduced = transformer.model_split(top["embed"][1], 0) + per_layer * cfg.n_layers
    _add(per_mb, "all-reduce", (reduced + recomputed * cfg.n_layers) * n_pos * ring, stream)
    _add(per_mb, "all-reduce", reduced * n_pos * ring, stream)
    if cfg.n_experts:
        _moe_exchanges(per_mb, cfg, mesh, batch // tcfg.microbatches * seq, fwd_layers)
    _add(per_mb, "all-reduce", 3 * n_pos * ring, loss_rows)
    _add(per_mb, "all-reduce", 2 * d * ring, loss_rows)
    _add(per_mb, "gather", 2 * (d - 1), loss_rows)
    _add(per_mb, "gather", d - 1, rows * cfg.d_model * 4)
    for kind, e in per_mb.items():
        out[kind] = {"count": e["count"] * tcfg.microbatches,
                     "bytes": e["bytes"] * tcfg.microbatches}

    for path, leaf in layers._iter_leaves(model.build_schema(cfg)):
        held, mom = model._at(pl.params, path).spec, model._at(pl.opt.m, path).spec
        n = len(leaf.shape)
        cur = local(leaf.shape, held)
        for dim, (a, b) in enumerate(zip(_padded(held, n), _padded(mom, n))):
            if a != b:
                for axis in sharding.axes_of(b):
                    cur[dim] //= mesh.shape[axis]
                    _add(out, "reduce-scatter", n_pos * (mesh.shape[axis] - 1),
                         math.prod(cur) * 4)
        split = {x for e in _padded(mom, n) for x in sharding.axes_of(e)}
        for axis in mesh.axis_names:
            if axis not in split:
                _add(out, "all-reduce", n_pos * (mesh.shape[axis] - 1), math.prod(cur) * 4)
        gathers(leaf.shape, mom, held, out, 1)
    for axis in mesh.axis_names:
        _add(out, "all-reduce", n_pos * (mesh.shape[axis] - 1), 4)
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    return out


def _moe_exchanges(out: dict, cfg, mesh, n_tokens: int, fwd_layers: int) -> None:
    """The exchanges of ``cfg.n_layers`` MoE layers of the partitioned step
    over a microbatch of ``n_tokens`` tokens (``partitioned_train_exchanges``)."""
    from repro_torch.models import layers, moe

    m, n_pos = mesh.shape["model"], math.prod(mesh.sizes)
    tok_axes, n_split, t_loc, cap = moe.ep_layout(n_tokens, cfg, mesh)
    if cfg.moe_impl == "dense":
        cap = min(t_loc, moe._capacity(cfg, n_tokens))
    dt = torch.empty((), dtype=layers.COMPUTE_DTYPE).element_size()
    n = cfg.n_layers
    moves = n_pos * (m - 1)
    buf = cfg.n_experts // m * cap * cfg.d_model * dt
    _add(out, "all-to-all", 2 * moves * (fwd_layers + 1) * n, buf)
    if "model" in tok_axes:
        _add(out, "all-gather", moves * n, t_loc * cfg.d_model * dt)
        _add(out, "reduce-scatter", moves * n, t_loc * cfg.d_model * dt)
    if cfg.moe_impl == "dense":
        _add(out, "all-gather", n_pos * (n_split - 1) * fwd_layers * n, cfg.n_experts * 4)
    _add(out, "gather", 2 * (n_split - 1) * n, 4)


def _padded(spec, n: int) -> list:
    return list(spec) + [None] * (n - len(spec))
