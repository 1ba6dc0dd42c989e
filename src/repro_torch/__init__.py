"""repro_torch: the fleet ODL engine (OS-ELM + auto data pruning) in PyTorch.

The PyTorch/CUDA counterpart of the JAX package ``repro``, module for module
(``core/``, ``kernels/``, ``engine/``, ``data/``, ``configs/``), held against
it by ``tests/test_torch_*.py``.  It imports neither JAX nor ``repro``.

Entry points build their tensors on CUDA unless the caller names another
device (``device="cpu"``, as the tests do); with no CUDA device and no
explicit device they raise.  The two device-heavy steps of a tick go through
hand-written Hopper kernels on CUDA tensors (``kernels/csrc/*.cu``) and
through their plain PyTorch versions on CPU tensors.

f32 means full f32: importing the package switches TF32 off for matmuls and
cuDNN, because the parity tolerances (1e-5 on the projection) need it.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point builds on: CUDA unless the caller names one.

    Never falls back to the CPU silently: with no CUDA device and no
    explicit ``device`` this raises.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA and no CUDA device is available; "
                "pass device='cpu' to run the plain versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
