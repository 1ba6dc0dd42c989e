"""ODLHash hidden projection on Hopper: the launch wrapper of
``csrc/xorshift_proj.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/xorshift_proj.py::
xorshift_projection`` (``_proj_kernel``).  The kernel is a GEMM on the
tensor cores (wgmma, TF32) whose B operand, the ODLHash matrix alpha, is
generated tile by tile inside each block from the counter hash and never
stored, so device memory sees only x in and H out.  alpha splits exactly
into two TF32 parts and x into a TF32 part and a remainder, so three TF32
products keep the f32 tolerance (1e-5); the integer work of hashing and
splitting into shared memory is what bounds it.  See the source for the
design.

Two routes, chosen by ``projection_plan`` from the shape and taken by the
launch as they are: one pass (a block per 128 x 128 tile of H, walking all
of K) where the rows fill the card, and at few rows a split of K over
blocks whose partial sums a second small pass adds in a fixed order.  The
order of summation over K is a function of n_in alone, so a row's H is
bit-identical whatever the number of rows and whichever route is taken.

Plain version: ``ref.xorshift_projection_ref``.  Device dispatch and the
launch count live in ``ops``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build

# Activation codes understood by the kernel's epilogue.
ACTIVATIONS = {"sigmoid": 0, "relu": 1, "tanh": 2, "identity": 3}

BM = BN = 128  # rows and columns of H per block (csrc/xorshift_proj.cu)
BK = 32  # depth of one K tile
SMS = 132  # streaming multiprocessors of an H100 SXM: one wave of blocks
GROUPS = 64  # K is summed in at least this many groups where it has the tiles
SPLIT_MAX_BLOCKS = 32  # one-pass blocks up to which the K range is split


class ProjectionPlan(NamedTuple):
    """The launch of one projection: ``grid`` (row tiles, column tiles, K
    splits); K tiles are summed in ``groups`` groups of ``group`` tiles
    (tile sums in order into a group sum, group sums in order into the
    total); each block takes ``groups_per_block`` groups; the split route
    (K splits > 1) keeps its partials in ``workspace_bytes`` of device
    memory, 0 on the one-pass route."""

    grid: tuple[int, int, int]
    group: int
    groups: int
    groups_per_block: int
    workspace_bytes: int

    @property
    def split(self) -> bool:
        return self.grid[2] > 1


def k_groups(n_in: int) -> tuple[int, int]:
    """(tiles per group, groups) of the order of summation over K: a
    function of n_in alone, shared by both routes.  Up to 2 * GROUPS tiles a
    group is one tile (the single chain of tile sums); past that, groups of
    n_tiles // GROUPS tiles, so that a split has at least GROUPS groups to
    spread and its workspace stays under 2 * GROUPS partials."""
    n_tiles = -(-n_in // BK)
    group = max(1, n_tiles // GROUPS)
    return group, -(-n_tiles // group)


def projection_plan(b: int, n_in: int, n_hidden: int,
                    split_max_blocks: int = SPLIT_MAX_BLOCKS) -> ProjectionPlan:
    """The plan of the projection of ``b`` rows of ``n_in`` into
    ``n_hidden``.  Where the one-pass grid has more than ``split_max_blocks``
    blocks it is taken as it is (at the fleet's 16,384 rows, 128 blocks in
    one wave); else the K groups are split over blocks so that the grid
    comes near one wave of SMS blocks, each block with a contiguous run of
    whole groups, and the partials take groups * b * n_hidden floats.
    (``split_max_blocks`` other than the default forces a route, for the
    card's checks and timings.)"""
    if b < 1 or n_in < 1 or n_hidden < 1:
        raise ValueError(f"no projection plan for b={b}, n_in={n_in}, n_hidden={n_hidden}")
    rows, cols = -(-b // BM), -(-n_hidden // BN)
    group, groups = k_groups(n_in)
    base = rows * cols
    if base <= split_max_blocks and groups > 1:
        per_block = -(-groups // max(1, SMS // base))
        splits = -(-groups // per_block)
        if splits > 1:
            return ProjectionPlan((rows, cols, splits), group, groups, per_block,
                                  4 * groups * b * n_hidden)
    return ProjectionPlan((rows, cols, 1), group, groups, groups, 0)


@functools.cache
def _launcher():
    lib = build.library("xorshift_proj")
    fn = lib.xorshift_proj_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        *[ctypes.c_int] * 6, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.xorshift_proj_error_string.argtypes = [ctypes.c_int]
    lib.xorshift_proj_error_string.restype = ctypes.c_char_p
    return fn, lib.xorshift_proj_error_string


def xorshift_projection(
    x: torch.Tensor,
    seed: int,
    n_hidden: int,
    scale: float = 1.0,
    activation: str = "sigmoid",
    plan: ProjectionPlan | None = None,
) -> torch.Tensor:
    """H = act((x @ alpha(seed)) * scale / sqrt(n_in)) on the card.

    x: (B, n_in) contiguous f32 or bf16 CUDA tensor -> H: (B, n_hidden) f32.
    ``plan`` defaults to ``projection_plan`` of the shape (another plan of
    the same shape, as the tests and the timings pass, must give the same
    H bit for bit).  The split route's partials go to a workspace allocated
    here.  Raises on anything the kernel does not take, and if the launch
    fails.
    """
    if x.device.type != "cuda":
        raise ValueError(f"xorshift_projection kernel needs a CUDA tensor, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (B, n_in), got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if n_hidden <= 0:
        raise ValueError(f"n_hidden must be positive, got {n_hidden}")
    b, n_in = x.shape
    h = torch.empty((b, n_hidden), dtype=torch.float32, device=x.device)
    if b == 0:
        return h
    if plan is None:
        plan = projection_plan(b, n_in, n_hidden)
    elif ((plan.group, plan.groups) != k_groups(n_in)
          or plan.grid[:2] != (-(-b // BM), -(-n_hidden // BN))
          or plan.grid[2] * plan.groups_per_block < plan.groups
          or plan.split != (plan.workspace_bytes == 4 * plan.groups * b * n_hidden)):
        raise ValueError(f"plan {plan} does not fit b={b}, n_in={n_in}, n_hidden={n_hidden}")
    ws = None
    if plan.split:
        ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32, device=x.device)
    launch, error_string = _launcher()
    with torch.cuda.device(x.device):
        rc = launch(
            x.data_ptr(),
            int(x.dtype == torch.bfloat16),
            h.data_ptr(),
            b,
            n_in,
            n_hidden,
            seed & 0xFFFFFFFF,
            float(np.float32(scale)),
            float(np.float32(1.0 / np.sqrt(n_in))),
            ACTIVATIONS[activation],
            *plan.grid,
            plan.group,
            plan.groups,
            plan.groups_per_block,
            None if ws is None else ws.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"xorshift_proj launch failed: {error_string(rc).decode()}")
    return h
