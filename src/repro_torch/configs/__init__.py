"""Config registry of the port: ``get_config(arch_id, variant)`` for every
architecture of the JAX package (``repro/configs/__init__.py``), plus
``har_odl`` (the paper's own ODL core, no backbone).

The architecture configs are data, copied from the JAX package field for
field; the port serves the dense GQA family (``models/``), and
``models.transformer`` raises for the families it does not have yet.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    LM_SHAPES,
    ModelConfig,
    ODLHeadConfig,
    ShapeConfig,
    TrainConfig,
    shape_by_name,
)

ARCH_IDS = (
    "deepseek-moe-16b",
    "deepseek-v2-236b",
    "h2o-danube-1.8b",
    "deepseek-coder-33b",
    "mistral-nemo-12b",
    "qwen3-4b",
    "mamba2-780m",
    "recurrentgemma-9b",
    "chameleon-34b",
    "whisper-small",
)

_MODULES = {
    a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS
}


def get_config(arch_id: str, variant: str = "full") -> ModelConfig:
    """Load an architecture config ('full' or 'smoke')."""
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch_id])
    return getattr(mod, variant)()


def cells(arch_id: str):
    """The (shape, runnable, reason) cells of an arch: long_500k only where
    attention is sub-quadratic (the reference's rule)."""
    cfg = get_config(arch_id)
    out = []
    for s in LM_SHAPES:
        if s.name == "long_500k" and not cfg.sub_quadratic:
            out.append((s, False, "full attention is quadratic at 524k"))
        else:
            out.append((s, True, ""))
    return out
