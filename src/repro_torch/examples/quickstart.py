"""Quickstart: the paper's tiny supervised ODL core in ~40 lines, on the port.

Trains an ODLHash core (n=561, N=128, m=6) on the HAR surrogate, hits it
with the subject drift, retrains online with auto data pruning, and prints
the accuracy recovery + communication saving (paper Fig. 3 'Auto').

The whole loop runs on ``repro_torch.engine`` — the same batched state
machine that serves thousands of streams — here as a fleet of exactly one.
Counterpart of the JAX package's ``examples/quickstart.py``.

Run:  python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

import torch

from repro_torch import engine, resolve_device
from repro_torch.core import labels, oselm, pruning
from repro_torch.data import har


def main(argv=None):
    ap = argparse.ArgumentParser(description="the paper's ODL core, one stream")
    ap.add_argument("--device", default=None, help="default: cuda")
    device = resolve_device(ap.parse_args(argv).device)
    data = har.generate(seed=0)

    elm = oselm.OSELMConfig(n_in=561, n_hidden=128, n_out=6, variant="hash")
    cfg = engine.EngineConfig(elm=elm, prune=pruning.PruneConfig.for_hidden(128))

    # Initial training (paper §3 step 1): classic OS-ELM batch boot, then
    # broadcast to a one-stream fleet.
    on = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    core = engine.init_state(cfg, device)._replace(
        elm=oselm.init_state_batch(elm, on(data.train_x), labels.one_hot(on(data.train_y), 6))
    )
    fleet = engine.broadcast_streams(core, 1)
    acc = lambda st, x, y: float(engine.fleet_accuracy(st, on(x), on(y), cfg)[0])  # noqa: E731
    print(f"before drift (test0): {100*acc(fleet, data.test0_x, data.test0_y):.1f}%")

    # Drift: five held-out subjects (paper §3 steps 3-4).
    ox, oy, tx, ty = har.odl_split(data, frac=0.6, seed=0)
    print(f"after drift, NO ODL : {100*acc(fleet, tx, ty):.1f}%")

    # Supervised ODL with auto data pruning over the drifted stream: re-arm
    # the pruning phase counter, then run the retraining phase.
    fleet = fleet._replace(prune=pruning.reset_phase(fleet.prune))
    fleet, outs = engine.run_fleet(
        fleet, on(ox)[:, None], on(oy.astype("int32"))[:, None], cfg, mode="train_phase",
        chunk=engine.CHUNK_TICKS,
    )
    head = engine.stream_slice(fleet, 0)
    comm = float(pruning.comm_volume_fraction(head.prune))
    print(f"after drift, ODL    : {100*acc(fleet, tx, ty):.1f}%")
    print(f"teacher queries     : {int(head.prune.queries)}/{len(ox)} "
          f"({100*comm:.1f}% comm volume, {100*(1-comm):.1f}% saved)")
    print(f"bytes to teacher    : {int(head.meter.up_bytes):,} "
          f"(saved {int((1/comm - 1) * head.meter.up_bytes):,})")
    print(f"final auto-theta    : {float(pruning.theta_of(head.prune, cfg.prune)):.2f}")


if __name__ == "__main__":
    main()
