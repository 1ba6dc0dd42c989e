"""Shared harness for the paper-table benchmarks, on the port's fleet engine.

Counterpart of ``boot_core``, ``drift_trial`` and ``mean_std`` in the JAX
package's ``benchmarks/common.py``, with the same protocol: a batch boot
(``oselm.init_state_batch``), a one-stream fleet (``broadcast_streams``),
``reset_phase`` and a one-stream ``engine.run_fleet(mode="train_phase")``
over the §3 retraining stream, accuracy by ``engine.fleet_accuracy``.

Every entry point takes ``device``: CUDA unless the caller names another
(``resolve_device``), never a silent fall back to the CPU.  On the card each
tick's projection (ODLHash) and RLS update go through the hand-written
kernels; ODLBase's ``x @ alpha`` is a ``torch.matmul`` in f32, as the JAX
package computes it outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import engine, resolve_device
from repro_torch.core import labels, oselm, pruning
from repro_torch.data import har


def boot_core(splits, run_seed: int, theta, n_hidden: int = 128, variant: str = "hash",
              device=None):
    """Initial-training boot of the paper's core (§3 steps 1-2); returns
    ``(cfg, state)`` with an axis-free (single-head) state on ``device``."""
    device = resolve_device(device)
    elm_cfg = oselm.OSELMConfig(
        n_in=har.N_FEATURES, n_hidden=n_hidden, n_out=har.N_CLASSES,
        variant=variant, seed=run_seed + 77, ridge=1e-2,
    )
    if theta == "auto":
        pcfg = pruning.PruneConfig(min_trained=max(n_hidden, 288))
    else:
        pcfg = pruning.PruneConfig(ladder=(float(theta),), min_trained=max(n_hidden, 288))
    cfg = engine.EngineConfig(elm=elm_cfg, prune=pcfg)
    x0 = torch.as_tensor(splits.train_x, device=device)
    y0 = labels.one_hot(torch.as_tensor(splits.train_y, device=device), har.N_CLASSES)
    st0 = oselm.init_state_batch(elm_cfg, x0, y0)
    return cfg, engine.init_state(cfg, device)._replace(elm=st0)


def drift_trial(run_seed: int, theta, n_hidden: int = 128, variant: str = "hash",
                dataset_seed: int = 0, device=None):
    """One full §3 protocol run; returns dict of accuracies + comm volume.

    The retraining phase is a one-stream ``engine.run_fleet`` (the same
    state machine the fleet and stream paths run at S=thousands).
    """
    device = resolve_device(device)
    splits = har.generate(seed=dataset_seed)
    cfg, core = boot_core(splits, run_seed, theta, n_hidden, variant, device)
    ox, oy, tx, ty = har.odl_split(splits, 0.6, run_seed)

    fleet = engine.broadcast_streams(core, 1)

    def acc(state, x, y):
        return float(engine.fleet_accuracy(
            state, torch.as_tensor(x, device=device), torch.as_tensor(y, device=device), cfg)[0])

    before = acc(fleet, splits.test0_x, splits.test0_y)
    noodl_after = acc(fleet, tx, ty)

    # Paper §3 step 3: new training phase (re-arm pruning condition 1).
    fleet = fleet._replace(prune=pruning.reset_phase(fleet.prune))
    fleet, _ = engine.run_fleet(
        fleet, torch.as_tensor(ox, device=device)[:, None],
        torch.as_tensor(oy.astype(np.int32), device=device)[:, None],
        cfg, mode="train_phase",
    )
    after = acc(fleet, tx, ty)
    prune_one = engine.stream_slice(fleet, 0).prune
    comm = float(pruning.comm_volume_fraction(prune_one))
    return dict(before=before, after=after, noodl_after=noodl_after, comm=comm,
                queries=int(prune_one.queries), skips=int(prune_one.skips))


def mean_std(rows, key):
    v = np.asarray([r[key] for r in rows])
    return float(v.mean()), float(v.std())
