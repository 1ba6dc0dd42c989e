"""Cascade serving: the paper's data pruning as a serving-cost saver, on the
port (counterpart of the JAX package's ``examples/serve_cascade.py``).

Setup: B streams decode concurrently; each stream belongs to a latent
domain (its token distribution).  The per-stream OS-ELM heads learn to
classify the domain from backbone features, online, from teacher labels.
The P1P2 gate + auto-theta decides per tick which streams still need the
teacher — as heads converge, teacher traffic collapses, the
communication-volume curve of paper Fig. 3 transplanted into an LLM-serving
cascade.

Run:  python -m repro_torch.examples.serve_cascade [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.models import model as model_lib


def main(argv=None):
    ap = argparse.ArgumentParser(description="the ODL serving cascade on a backbone")
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = configs.get_config(args.arch, "smoke")
    params = model_lib.build_params(cfg, seed=0, device=device)

    # Domain-coherent streams: stream s draws tokens from domain s % n_out;
    # precompute each domain's 100 most likely token ids once.
    n_dom = cfg.odl.n_out
    domains = np.arange(args.batch) % n_dom
    tables = TokenStream(TokenStreamConfig(cfg.vocab_size, 1, 1, n_domains=n_dom))._tables
    top_ids = np.argsort(tables, axis=1)[:, -100:]  # (n_dom, 100)

    state = model_lib.init_serve_state(cfg, args.batch, max_len=args.ticks + 4, device=device)
    labels = torch.as_tensor(domains, dtype=torch.int32, device=device)  # teacher = true domain
    window = []
    for t in range(args.ticks):
        tok = np.stack([top_ids[d, (t + i) % 100] for i, d in enumerate(domains)])
        tok = torch.as_tensor(tok.astype(np.int64)[:, None], device=device)
        _, state, odl = model_lib.serve_step(params, state, tok, cfg)
        q = odl.queried
        # The teacher answers this tick's queries (synchronously, for
        # clarity); the GateOutput carries the query-time context the
        # answer is judged against.
        state = model_lib.serve_apply_labels(state, odl, labels, q, cfg)
        window.append(float(q.float().mean()))
        if (t + 1) % 20 == 0:
            frac = np.mean(window[-20:])
            print(f"tick {t+1:4d}: teacher query fraction (last 20) = {frac:.2f}")

    early, late = np.mean(window[:20]), np.mean(window[-20:])
    print(f"\nteacher traffic: first 20 ticks {early:.2f} -> last 20 ticks {late:.2f}")
    print("the P1P2/auto-theta gate prunes teacher calls as the fleet adapts"
          if late < early else "heads still warming up — raise --ticks")


if __name__ == "__main__":
    main()
