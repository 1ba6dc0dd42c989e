"""GPipe-style pipeline parallelism over a "stage" mesh axis (PyTorch
counterpart of ``repro/distributed/pipeline.py``).

Layers are split into S stages; each stage's params live on its entry of
the ``stage`` axis; M microbatches stream through, and the classic GPipe
schedule runs S + M - 1 ticks (bubble fraction (S - 1)/(S + M - 1)).

Register formulation, as the reference's: every stage holds one activation
register.  At tick t, stage s processes microbatch t - s: stage 0 reads
microbatch t from the input, stages > 0 read the register the previous
tick handed them, and the last stage publishes microbatch t - (S - 1).
The reference hands registers on with one ``ppermute`` a tick inside
``shard_map``; here one process runs the stages of a tick in turn, so the
hand-off is an explicit move of each stage's output to the next stage's
entry (``sharding.exchange``: a ``collective-permute`` in a census), made
after every stage of the tick has read its register.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.sharding import Mesh, exchange


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def pipeline_forward(
    h: torch.Tensor,  # (M, B_mb, ...) microbatched activations
    stage_params,  # tree with a leading (n_stages, ...) dim on every leaf
    stage_fn: Callable,  # (h_mb, params_one_stage) -> h_mb
    mesh: Mesh,
    axis: str = "stage",
) -> torch.Tensor:
    """Run M microbatches through the pipeline on ``mesh``'s ``axis`` (the
    mesh's only axis); returns (M, B_mb, ...) on h's device."""
    if mesh.axis_names != (axis,):
        raise ValueError(f"pipeline_forward runs on a ({axis!r},) mesh, not {mesh.axis_names}")
    n_stages, m = mesh.shape[axis], h.shape[0]
    devices = [mesh.device_at((s,)) for s in range(n_stages)]
    params = [_map(lambda a, s=s: a[s].to(devices[s]), stage_params) for s in range(n_stages)]
    regs = [torch.zeros_like(h[0], device=dev) for dev in devices]
    outputs = [None] * m
    last = n_stages - 1
    for t in range(n_stages + m - 1):
        ys = []
        for s in range(n_stages):
            inp = h[min(t, m - 1)].to(devices[s]) if s == 0 else regs[s]
            ys.append(stage_fn(inp, params[s]))
        if 0 <= t - last < m:
            outputs[t - last] = ys[last].to(h.device)
        # Hand off: stage s's output becomes stage s + 1's register.
        regs = [regs[0]] + [exchange(ys[s - 1], (s - 1,), (s,), mesh, "collective-permute")
                            for s in range(1, n_stages)]
    return torch.stack(outputs)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble overhead: (S - 1) / (S + M - 1)."""
    return (n_stages - 1) / (n_stages + n_microbatches - 1)


def sequential_reference(h, stage_params, stage_fn, n_stages: int):
    """Apply all stages in order to every microbatch (the test oracle)."""
    out = []
    for mb in range(h.shape[0]):
        x = h[mb]
        for s in range(n_stages):
            x = stage_fn(x, _map(lambda a, s=s: a[s], stage_params))
        out.append(x)
    return torch.stack(out)
