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

Plain version: ``ref.xorshift_projection_ref``.  Device dispatch and the
launch count live in ``ops``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build

# Activation codes understood by the kernel's epilogue.
ACTIVATIONS = {"sigmoid": 0, "relu": 1, "tanh": 2, "identity": 3}


@functools.cache
def _launcher():
    lib = build.library("xorshift_proj")
    fn = lib.xorshift_proj_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
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
) -> torch.Tensor:
    """H = act((x @ alpha(seed)) * scale / sqrt(n_in)) on the card.

    x: (B, n_in) contiguous f32 or bf16 CUDA tensor -> H: (B, n_hidden) f32.
    Raises on anything the kernel does not take, and if the launch fails.
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
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"xorshift_proj launch failed: {error_string(rc).decode()}")
    return h
