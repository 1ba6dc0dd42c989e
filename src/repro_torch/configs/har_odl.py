"""har-odl — the paper's own configuration (no backbone).

OS-ELM core with n=561, N=128, m=6 (paper §2.3 prototype), ODLHash variant,
auto data pruning with the {1, .64, .32, .16, .08} ladder and X=10.
"""

from repro_torch.core import drift, oselm, pruning
from repro_torch.engine.types import EngineConfig


def full(n_hidden: int = 128, variant: str = "hash") -> EngineConfig:
    elm = oselm.OSELMConfig(
        n_in=561, n_hidden=n_hidden, n_out=6, variant=variant, ridge=1e-2
    )
    return EngineConfig(
        elm=elm,
        prune=pruning.PruneConfig.for_hidden(n_hidden),
        drift=drift.DriftConfig(),
    )


def smoke() -> EngineConfig:
    return full(n_hidden=16)
