"""Rank-k RLS (OS-ELM) update on Hopper: the launch wrappers of
``csrc/oselm_update.cu``.

Replaces the Pallas TPU kernels ``repro/kernels/oselm_update.py::
oselm_rls_update_fleet`` (``_rls_fleet_kernel`` with its wrapper's jnp
small-operand stage) and, as its S = 1 case, ``oselm_rls_update``
(``_rls_kernel``).  Two routes, chosen by shape in ``ops.rls_route``:

* the single pass (``rls_single``), for N <= 256, k <= 64, N a multiple of
  4 and a shared-memory layout that fits: one launch takes (P, β, H, Y) and
  computes PHt = P Hᵀ, S = I + H PHt, G = S⁻¹ PHtᵀ, E = Y − H β, W = Hᵀ E,
  P' = P − PHt G and β' = β + P' W, each P byte read once and written
  once.  Persistent clusters (``single_pass_plan``: blocks per stream and
  stages of the ring; as many clusters as the card holds at once) walk the
  streams; from k = 2 rows a stream spreads over a cluster of four blocks
  at N = 128, and k = 1 on a cluster (N = 256) takes a body of its own
  (``rank1_cluster``);
* the two-stage route for every other shape: the small operands in plain
  torch (``small_operands``, as the JAX wrapper computes them outside its
  ``pallas_call``), then the fused pass (``rls_fleet``).

Both are bound by device memory (P in and P' out); see the source for the
designs.  Plain version: ``ref.rls_update_ref``.  Device dispatch and the
launch counts live in ``ops``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import small_operands  # the two-stage route's first stage

__all__ = ["launch_clusters", "rank1_cluster", "rls_fleet", "rls_single", "single_pass_plan",
           "single_pass_smem_bytes", "small_operands"]

SINGLE_MAX_N = 256
SINGLE_MAX_K = 64
SINGLE_MAX_ROWS = 128  # rows of P per block; more go to a cluster of blocks
CLUSTER_SIZES = (1, 2, 4)
SPREAD_MIN_K = 2  # from this rank on a stream is spread over a cluster ...
SPREAD_MIN_ROWS = 32  # ... of as many blocks as keep this many rows of P each
MAX_STAGES = 3
MAX_SMEM_BYTES = 227 * 1024  # dynamic shared memory a block may opt into on Hopper
_BAR_BYTES = 32
RANK1_CLUSTER_MAX_ROWS = 64  # rows of P a block of the rank-1 cluster body holds at most
RANK1_CLUSTER_MAX_M = 8
_RANK1_E = 8  # floats of an exchange slot after its rows of PHt


def rank1_cluster(n: int, k: int, m: int, c: int) -> bool:
    """Whether a cluster of ``c`` blocks runs (N, k, m) with the rank-1
    cluster body (``rls_rank1_cluster_kernel``; ``rank1_cluster`` in
    ``csrc/oselm_update.cu`` says the same): k = 1 on a cluster, N <= 256,
    m <= 8, and each block's R = N / c rows at most 64 and a multiple of 4.
    The fleet's N = 256 plan (4, 3) takes it; N <= 128 at k = 1 runs on one
    block (``rank1_stream``) and every other shape on the general body."""
    r = n // c
    return (k == 1 and c > 1 and m <= RANK1_CLUSTER_MAX_M and n <= SINGLE_MAX_N
            and r <= RANK1_CLUSTER_MAX_ROWS and r % 4 == 0)


def single_pass_smem_bytes(n: int, k: int, m: int, c: int, ns: int) -> int:
    """Shared memory of one block of the single pass, the same layouts as
    ``Layout`` and ``Rank1Layout`` in ``csrc/oselm_update.cu``: the
    mbarriers, then in floats

    * the general body: ``ns`` stages of [its rows of P (R x N, R = N / c)
      | H / G (k x N) | β (N x m)], Wᵀ (m x N), its rows of PHt (R x (k | 1):
      rows padded to an odd stride), two k x k buffers and E (k x m);
    * the rank-1 cluster body (``rank1_cluster``): ``ns`` stages of [its
      rows of P (R x N) | h (N) | its rows of β (R x m)], then two exchange
      areas (by the stream's parity) of ``c`` slots of R + 8 floats (a
      block's rows of PHt and its share of H β)."""
    r = n // c
    if rank1_cluster(n, k, m, c):
        return _BAR_BYTES + 4 * (ns * (r * n + n + r * m) + 2 * c * (r + _RANK1_E))
    stage = r * n + k * n + n * m
    return _BAR_BYTES + 4 * (ns * stage + m * n + r * (k | 1) + 2 * k * k + k * m)


def single_pass_plan(n: int, k: int, m: int) -> tuple[int, int] | None:
    """(blocks per stream, stages) of the single pass for this shape, or
    None where it does not take the shape: N > 256, k > 64, N not a multiple
    of 4 (rows of P must be 16-byte aligned for the bulk copies), or no
    cluster of 1, 2 or 4 blocks of at most 128 rows each whose layout fits.
    The smallest cluster with two stages or more wins, else the smallest
    with one; from rank SPREAD_MIN_K on, the largest whose blocks keep
    SPREAD_MIN_ROWS rows or more comes first (a one-head update of k rows
    then spreads over several SMs instead of one: at N = 128 four blocks of
    32 rows were faster than one block at every k from 2 to 64 on an H100,
    and slower at k = 1, whose one-block path is the fleet's).  The fleet's
    N = 256 at k = 1 takes (4, 3): four blocks of 64 rows on the rank-1
    cluster body (``rank1_cluster``: three stages of 68,096 B and the
    exchange slots, one cluster barrier a stream).  The launch runs as many
    clusters as the card holds at once (``launch_clusters``).  A function
    of (N, k, m) alone: a stream's P' must not depend on how many streams
    share the call."""
    if not (1 <= n <= SINGLE_MAX_N and 1 <= k <= SINGLE_MAX_K and m >= 1 and n % 4 == 0):
        return None
    order = CLUSTER_SIZES
    if k >= SPREAD_MIN_K:
        order = ([c for c in reversed(CLUSTER_SIZES) if n // c >= SPREAD_MIN_ROWS]
                 + [c for c in CLUSTER_SIZES if n // c < SPREAD_MIN_ROWS])
    fits = []
    for c in order:
        if n % c or n // c > SINGLE_MAX_ROWS:
            continue
        ns = max((s for s in range(1, MAX_STAGES + 1)
                  if single_pass_smem_bytes(n, k, m, c, s) <= MAX_SMEM_BYTES), default=0)
        if ns >= 2:
            return c, ns
        if ns == 1:
            fits.append((c, 1))
    return fits[0] if fits else None


@functools.cache
def _lib():
    lib = build.library("oselm_update")
    lib.oselm_rls_single_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    lib.oselm_rls_single_launch.restype = ctypes.c_int
    lib.oselm_rls_single_clusters.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    lib.oselm_rls_single_clusters.restype = ctypes.c_int
    lib.oselm_rls_single_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.oselm_rls_single_smem_bytes.restype = ctypes.c_int
    lib.oselm_rls_fleet_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.oselm_rls_fleet_launch.restype = ctypes.c_int
    lib.oselm_rls_fleet_error_string.argtypes = [ctypes.c_int]
    lib.oselm_rls_fleet_error_string.restype = ctypes.c_char_p
    return lib


def kernel_smem_bytes(n: int, k: int, m: int, c: int, ns: int) -> int:
    """The kernel library's own count of ``single_pass_smem_bytes`` (the
    card's checks hold the two equal)."""
    return int(_lib().oselm_rls_single_smem_bytes(n, k, m, c, ns))


def launch_clusters(s: int, n: int, k: int, m: int, plan: tuple[int, int] | None = None,
                    clusters: int | None = None) -> int:
    """The clusters a single-pass launch of ``s`` streams runs on the
    current card (``rls_single``'s grid is this times the plan's blocks):
    as many as the card holds at once (one block an SM for a cluster of
    one; ``cudaOccupancyMaxActiveClusters`` else, asked once per kernel,
    cluster and shared memory), at most ``s``; ``clusters`` asks for that
    many instead.  Raises if the card cannot say."""
    c, ns = single_pass_plan(n, k, m) if plan is None else plan
    got = ctypes.c_int(0)
    _raise_on(_lib().oselm_rls_single_clusters(s, n, k, m, c, ns, clusters or 0,
                                               ctypes.byref(got)),
              "oselm_update single pass grid")
    return got.value


def _check(ops_: dict[str, torch.Tensor], want: dict[str, tuple], who: str) -> None:
    dev = ops_["P"].device
    for name, t in ops_.items():
        if t.device.type != "cuda":
            raise ValueError(f"{who} kernel needs CUDA tensors, {name} is on {t.device}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, P on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be 3-d, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want[name]}")


def _outputs(P: torch.Tensor, beta: torch.Tensor, inputs: tuple[torch.Tensor, ...],
             out: tuple[torch.Tensor, torch.Tensor] | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The (P', β') buffers a launch writes: fresh ones, or ``out`` once it is
    checked.  Both kernels write out of place and store P' 16 bytes at a
    time, so an ``out`` buffer must be a contiguous f32 tensor of P's (β's)
    shape on its device, 16-byte aligned, and overlap no input."""
    if out is None:
        return torch.empty_like(P), torch.empty_like(beta)
    for name, o, like in (("P out", out[0], P), ("beta out", out[1], beta)):
        if o.shape != like.shape or o.dtype != like.dtype or o.device != like.device:
            raise ValueError(f"{name} must be {like.dtype} {tuple(like.shape)} on {like.device}, "
                             f"got {o.dtype} {tuple(o.shape)} on {o.device}")
        if not o.is_contiguous() or o.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        for t in inputs:
            lo, hi = t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()
            if o.data_ptr() < hi and lo < o.data_ptr() + o.numel() * o.element_size():
                raise ValueError(f"{name} overlaps an input: the kernel writes out of place")
    return out


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {_lib().oselm_rls_fleet_error_string(rc).decode()}")


def rls_single(
    P: torch.Tensor,  # (S, N, N)
    beta: torch.Tensor,  # (S, N, m)
    H: torch.Tensor,  # (S, k, N)
    Y: torch.Tensor,  # (S, k, m)
    out: tuple[torch.Tensor, torch.Tensor] | None = None,
    plan: tuple[int, int] | None = None,
    clusters: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole update in one launch on the card; returns (P', β'), written
    into ``out`` when it is given (see ``_outputs``), else into new buffers.

    Every operand must be a contiguous f32 CUDA tensor on one device with the
    shapes above, P, β and H 16-byte aligned, and the shape one the single
    pass takes (``single_pass_plan``, whose plan it launches unless another
    (blocks per stream, stages) that fits is given: the card's timings
    compare plans so).  ``clusters`` runs that many persistent clusters
    instead of as many as fit (``launch_clusters``; a stream's result does
    not depend on it).  Raises on anything else, and if the launch fails.
    """
    s, n = P.shape[0], P.shape[1]
    k, m = H.shape[1], beta.shape[2]
    _check({"P": P, "beta": beta, "H": H, "Y": Y},
           {"P": (s, n, n), "beta": (s, n, m), "H": (s, k, n), "Y": (s, k, m)}, "rls_single")
    if single_pass_plan(n, k, m) is None:
        raise ValueError(f"the single pass does not take N={n}, k={k}, m={m}")
    if plan is None:
        plan = single_pass_plan(n, k, m)
    c, ns = plan
    if (c not in CLUSTER_SIZES or n % c or n // c > SINGLE_MAX_ROWS
            or not 1 <= ns <= MAX_STAGES
            or single_pass_smem_bytes(n, k, m, c, ns) > MAX_SMEM_BYTES):
        raise ValueError(f"plan {plan} does not fit N={n}, k={k}, m={m}")
    if clusters is not None and clusters < 1:
        raise ValueError(f"clusters must be positive, got {clusters}")
    for name, t in (("P", P), ("beta", beta), ("H", H)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the bulk copies")
    new_p, new_beta = _outputs(P, beta, (P, beta, H, Y), out)
    if s == 0:
        return new_p, new_beta
    with torch.cuda.device(P.device):
        rc = _lib().oselm_rls_single_launch(
            P.data_ptr(), beta.data_ptr(), H.data_ptr(), Y.data_ptr(),
            new_p.data_ptr(), new_beta.data_ptr(), s, n, k, m, *plan, clusters or 0,
            torch.cuda.current_stream(P.device).cuda_stream,
        )
    _raise_on(rc, "oselm_update single pass")
    return new_p, new_beta


def rls_fleet(
    P: torch.Tensor,  # (S, N, N)
    beta: torch.Tensor,  # (S, N, m)
    pht: torch.Tensor,  # (S, N, k)
    g: torch.Tensor,  # (S, k, N)
    w: torch.Tensor,  # (S, N, m)
    out: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused pass of the two-stage route on the card; returns (P', β'),
    written into ``out`` when it is given (see ``_outputs``), else into new
    buffers.

    Every operand must be a contiguous f32 CUDA tensor on one device with the
    shapes above.  Raises on anything else, and if the launch fails.
    """
    s, n = P.shape[0], P.shape[1]
    k, m = pht.shape[2], beta.shape[2]
    if k < 1 or m < 1:
        raise ValueError(f"rank k and outputs m must be positive, got k={k}, m={m}")
    _check({"P": P, "beta": beta, "pht": pht, "g": g, "w": w},
           {"P": (s, n, n), "beta": (s, n, m), "pht": (s, n, k), "g": (s, k, n),
            "w": (s, n, m)}, "rls_fleet")
    new_p, new_beta = _outputs(P, beta, (P, beta, pht, g, w), out)
    if s == 0 or n == 0:
        return new_p, new_beta
    with torch.cuda.device(P.device):
        rc = _lib().oselm_rls_fleet_launch(
            P.data_ptr(), beta.data_ptr(), pht.data_ptr(), g.data_ptr(), w.data_ptr(),
            new_p.data_ptr(), new_beta.data_ptr(), s, n, k, m,
            torch.cuda.current_stream(P.device).cuda_stream,
        )
    _raise_on(rc, "oselm_update two-stage pass")
    return new_p, new_beta
