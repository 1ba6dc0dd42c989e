"""CUDA graphs of the stream runtime's tick functions: the port's stand-in
for the JAX runtime's jitted per-tick runners (one dispatch per call).

A tick function ``fn(*fixed, *inputs)`` reads and writes the tensors in
``fixed`` in place (a session's state buffers, at addresses that do not
change), takes its per-tick values in ``inputs`` and returns a NamedTuple of
tensors or None.  It must read one set of buffers and write another, so that
calling it twice on the same inputs leaves the same result: the warm-up call
before a capture then leaves nothing the replay depends on.

``run`` calls a tick function eagerly on CPU tensors.  On CUDA tensors it
always replays a graph (``TickGraph``), captured on first use under a key the
caller gives (one per set of ``fixed`` buffers); a failed capture raises, and
there is no eager fallback.  A replay launches no Python, so it raises no
``kernels.ops.launch_counts``: each graph records which kernels it holds
(``ops.captured_counts`` during its capture), and every replay adds to
``replay_counts`` (by runner), ``kernel_replays`` (by kernel) and
``runner_kernel_replays`` (by runner, then kernel).  Captures are counted in
``capture_counts`` and their host time, warm-up included, in ``capture_ms``
(both by runner).  Runner names are the callers': a cohort's graphs carry a
``cohort.`` prefix, so its replays and captures read apart from a session's.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

from repro_torch.kernels import ops

replay_counts: dict[str, int] = {}
kernel_replays = dict.fromkeys(ops.launch_counts, 0)
runner_kernel_replays: dict[str, dict[str, int]] = {}
capture_counts: dict[str, int] = {}
capture_ms: dict[str, float] = {}


def reset_replay_counts() -> None:
    """Zero every tally of this module: replays and captures."""
    for tally in (replay_counts, runner_kernel_replays, capture_counts, capture_ms):
        tally.clear()
    for name in kernel_replays:
        kernel_replays[name] = 0


def copy_into(dsts: Sequence[torch.Tensor], srcs: Sequence[torch.Tensor]) -> None:
    """``dst.copy_(src)`` for each pair, as one ``_foreach_copy_`` per dtype
    (a multi-tensor copy takes one dtype)."""
    groups: dict[torch.dtype, tuple[list, list]] = {}
    for dst, src in zip(dsts, srcs, strict=True):
        d, s = groups.setdefault(dst.dtype, ([], []))
        d.append(dst)
        s.append(src)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


def _fresh_copy(out):
    """A NamedTuple like ``out`` whose tensors are new copies of its tensors."""
    fresh = [torch.empty_like(t) for t in out]
    copy_into(fresh, list(out))
    return type(out)(*fresh)


class TickGraph:
    """One captured call of a tick function on the card.

    Capture: ``inputs`` are copied into static input buffers, ``fn`` runs
    once on a side stream (the warm-up builds the kernels and sets their
    shared-memory opt-ins, so no such call happens inside the capture), then
    ``torch.cuda.CUDAGraph`` captures it.  Each call copies its inputs into
    the static buffers, replays, and returns a fresh copy of the outputs:
    nothing a caller keeps lives in a buffer the next replay overwrites.
    """

    def __init__(self, name: str, fn: Callable, fixed: tuple, inputs: Sequence[torch.Tensor]):
        t0 = time.perf_counter()
        self.name = name
        self._fixed = fixed  # the graph reads and writes these addresses
        self._inputs = [t.clone() for t in inputs]
        compute = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(compute)
        with torch.cuda.stream(side):
            fn(*fixed, *self._inputs)
        compute.wait_stream(side)
        before = dict(ops.captured_counts)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._out = fn(*fixed, *self._inputs)
        self.kernels = {k: n - before[k] for k, n in ops.captured_counts.items() if n > before[k]}
        capture_counts[name] = capture_counts.get(name, 0) + 1
        capture_ms[name] = capture_ms.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)

    def __call__(self, *inputs: torch.Tensor):
        for dst, src in zip(self._inputs, inputs, strict=True):
            if src.shape != dst.shape or src.dtype != dst.dtype or src.device != dst.device:
                raise ValueError(
                    f"{self.name}: input {src.dtype} {tuple(src.shape)} on {src.device} does not "
                    f"match the captured {dst.dtype} {tuple(dst.shape)} on {dst.device}")
        copy_into(self._inputs, inputs)
        self.graph.replay()
        replay_counts[self.name] = replay_counts.get(self.name, 0) + 1
        mine = runner_kernel_replays.setdefault(self.name, {})
        for k, n in self.kernels.items():
            kernel_replays[k] += n
            mine[k] = mine.get(k, 0) + n
        return None if self._out is None else _fresh_copy(self._out)


def run(cache: dict, key, name: str, fn: Callable, fixed: tuple,
        inputs: Sequence[torch.Tensor]):
    """``fn(*fixed, *inputs)``: eagerly on CPU tensors; on CUDA tensors the
    replay of ``cache[key]``, captured on first use (``TickGraph``)."""
    dev = inputs[0].device.type
    if dev == "cpu":
        return fn(*fixed, *inputs)
    if dev != "cuda":
        raise ValueError(f"tick functions run on CUDA or CPU tensors, got {inputs[0].device}")
    graph = cache.get(key)
    if graph is None:
        graph = cache[key] = TickGraph(name, fn, fixed, inputs)
    return graph(*inputs)
