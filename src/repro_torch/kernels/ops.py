"""Device dispatch for the kernels, and their launch counts.

A CPU tensor goes to the plain PyTorch version (``ref``); a CUDA tensor goes
to the hand-written kernel, and a failed build or launch raises — there is
no fallback.  Any other device raises.  The RLS update takes one of two
routes by shape (``rls_route``); that is a choice by shape, made before any
launch, never a retry.

``launch_counts`` holds one plain integer per kernel and route, raised by
one where the kernel is launched and nowhere else, so a run can show that
its main path went through the kernels (``chip_smoke.py`` reads it).  A
call made while a CUDA graph is being captured launches nothing: it records
the kernel into the graph, and raises ``captured_counts`` instead, from
which ``engine.graphs`` learns which kernels each of its graphs replays.
The keys of both:

* ``xorshift_projection`` — the projection kernel;
* ``oselm_rls_update_fleet`` — the single-pass RLS kernel, from the fleet entry;
* ``oselm_rls_update`` — the same kernel, from the one-head entry;
* ``rls_two_stage`` — the two-stage RLS route, from either entry;
* ``readout`` — the per-stream readout of ``plan``;
* ``row_abs_mean`` — the drift detector's feature mean (``algo1`` and
  ``serve`` plans).

Each wrapper's CPU path gives a row the same result whatever the number of
rows beside it, as its kernel does on the card: a cohort's stacked dispatch
must equal each member's own (``engine/cohort.py``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import oselm_update as _oselm_update
from repro_torch.kernels import plan_rows as _plan_rows
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import xorshift_proj as _xorshift_proj

launch_counts = {
    "xorshift_projection": 0,
    "oselm_rls_update_fleet": 0,
    "oselm_rls_update": 0,
    "rls_two_stage": 0,
    "readout": 0,
    "row_abs_mean": 0,
}
captured_counts = dict.fromkeys(launch_counts, 0)


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _count(name: str) -> None:
    """One launch of ``name`` on the current CUDA stream, or one kernel node
    recorded into the graph that stream is capturing."""
    counts = captured_counts if torch.cuda.is_current_stream_capturing() else launch_counts
    counts[name] += 1


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"repro_torch kernels run on CUDA or CPU tensors, got {t.device}")


def xorshift_projection(
    x: torch.Tensor,
    seed: int,
    n_hidden: int,
    scale: float = 1.0,
    activation: str = "sigmoid",
) -> torch.Tensor:
    """ODLHash projection H = act(x @ alpha(seed) * scale / sqrt(n_in)).

    Accepts (..., n_in); leading dims are flattened for the kernel.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _on_cuda(x2):
        h = _xorshift_proj.xorshift_projection(
            x2.contiguous(), seed, n_hidden, scale=scale, activation=activation
        )
        _count("xorshift_projection")
    else:
        h = _ref.xorshift_projection_ref(x2, seed, n_hidden, scale=scale, activation=activation)
    return h.reshape(lead + (n_hidden,))


def readout(h: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Per-stream readout o[s] = h[s] @ beta[s]: h (S, N), beta (S, N, m) -> (S, m)."""
    if _on_cuda(h):
        o = _plan_rows.readout(h.to(torch.float32).contiguous(), beta.contiguous())
        _count("readout")
        return o
    return _ref.readout_ref(h, beta)


def row_abs_mean(x: torch.Tensor) -> torch.Tensor:
    """mean(|x|) over the last axis: (..., n) -> (...) f32."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _on_cuda(x2):
        a = _plan_rows.row_abs_mean(x2.to(torch.float32).contiguous())
        _count("row_abs_mean")
    else:
        a = _ref.row_abs_mean_ref(x2)
    return a.reshape(lead)


def rls_route(n: int, k: int, m: int) -> str:
    """``"single"`` where the single-pass kernel takes (N, k, m), else
    ``"two_stage"`` (N > 256, k > 64, N not a multiple of 4, or a layout
    that does not fit in shared memory)."""
    return "two_stage" if _oselm_update.single_pass_plan(n, k, m) is None else "single"


def _rls(P, beta, H, Y, counter, out=None):
    if not _on_cuda(P):
        if P.shape[0] == 1:
            # torch's CPU batched products hand a batch of one to matrix-vector
            # routines that sum in another order: a lone stream is updated as
            # the first of two, like a stream of any larger batch.
            new = tuple(t[:1] for t in _ref.rls_update_ref(
                *(torch.cat([t, t]) for t in (P, beta, H, Y))))
        else:
            new = _ref.rls_update_ref(P, beta, H, Y)
        if out is None:
            return new
        for dst, src in zip(out, new):
            dst.copy_(src)
        return out
    P, beta = P.contiguous(), beta.contiguous()
    H, Y = H.to(torch.float32).contiguous(), Y.to(torch.float32).contiguous()
    if rls_route(P.shape[1], H.shape[1], beta.shape[2]) == "single":
        new = _oselm_update.rls_single(P, beta, H, Y, out=out)
        _count(counter)
    else:
        new = _oselm_update.rls_fleet(P, beta, *_oselm_update.small_operands(P, beta, H, Y),
                                      out=out)
        _count("rls_two_stage")
    return new


def oselm_rls_update_fleet(
    P: torch.Tensor,
    beta: torch.Tensor,
    H: torch.Tensor,
    Y: torch.Tensor,
    out: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank-k RLS update for S heads: P (S,N,N), beta (S,N,m), H (S,k,N),
    Y (S,k,m) -> (P', beta'), Pallas numerics.  With ``out`` the update is
    written into those two buffers (which must not overlap the inputs) and
    they are returned; else into new ones."""
    return _rls(P, beta, H, Y, "oselm_rls_update_fleet", out)


def oselm_rls_update(
    P: torch.Tensor, beta: torch.Tensor, H: torch.Tensor, Y: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank-k RLS update of one head: P (N,N), beta (N,m), H (k,N), Y (k,m)
    -> (P', beta').  The S = 1 case of ``oselm_rls_update_fleet``."""
    new_p, new_beta = _rls(P[None], beta[None], H[None], Y[None], "oselm_rls_update")
    return new_p[0], new_beta[0]
