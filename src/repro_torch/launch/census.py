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
    ``all-to-all``, ``collective-permute``).  A count is one tensor moved
    from one mesh position to another, its bytes the tensor's."""
    out = {kind: dict(v) for kind, v in census.exchanges.items()}
    out["total_bytes"] = sum(v["bytes"] for v in census.exchanges.values())
    return out
