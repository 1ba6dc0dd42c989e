"""Per-stream row reductions of ``plan`` on Hopper: the launch wrappers of
``csrc/plan_rows.cu``.

Not ports of a Pallas kernel: the readout ``o = h · beta`` and the drift
detector's feature mean ``mean(|x|)`` were torch ops, whose CUDA kernels
split a row's sum by the number of rows, so a cohort's stacked plan and a
member's own plan differed in the last bits.  These kernels give each
stream one warp with a fixed summation order, so a row's result does not
depend on how many rows share the launch.  See the source for the design.

Plain versions: ``ref.readout_ref`` and ``ref.row_abs_mean_ref``.  Device
dispatch and the launch counts live in ``ops``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


@functools.cache
def _lib():
    lib = build.library("plan_rows")
    lib.plan_rows_readout_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.plan_rows_readout_launch.restype = ctypes.c_int
    lib.plan_rows_abs_mean_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.plan_rows_abs_mean_launch.restype = ctypes.c_int
    lib.plan_rows_error_string.argtypes = [ctypes.c_int]
    lib.plan_rows_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32 or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-d float32 tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {_lib().plan_rows_error_string(rc).decode()}")


def readout(h: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """o[s] = h[s] @ beta[s] on the card: h (S, N), beta (S, N, m) -> (S, m) f32."""
    _check(h, "h", 2)
    _check(beta, "beta", 3)
    s, n = h.shape
    if beta.shape[:2] != (s, n) or beta.device != h.device:
        raise ValueError(f"beta {tuple(beta.shape)} does not match h {tuple(h.shape)}")
    m = beta.shape[2]
    out = torch.empty((s, m), dtype=torch.float32, device=h.device)
    if s == 0 or m == 0:
        return out
    with torch.cuda.device(h.device):
        rc = _lib().plan_rows_readout_launch(
            h.data_ptr(), beta.data_ptr(), out.data_ptr(), s, n, m,
            torch.cuda.current_stream(h.device).cuda_stream)
    _raise_on(rc, "readout")
    return out


def row_abs_mean(x: torch.Tensor) -> torch.Tensor:
    """mean(|x[s]|) on the card: x (S, n) f32 -> (S,) f32."""
    _check(x, "x", 2)
    s, n = x.shape
    out = torch.empty((s,), dtype=torch.float32, device=x.device)
    if s == 0:
        return out
    if n == 0:
        raise ValueError("row_abs_mean of rows with no elements")
    with torch.cuda.device(x.device):
        rc = _lib().plan_rows_abs_mean_launch(
            x.data_ptr(), out.data_ptr(), s, n, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "row_abs_mean")
    return out
