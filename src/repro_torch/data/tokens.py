"""Synthetic sharded token-stream pipeline for LM training (a copy of
``repro/data/tokens.py``, numpy only: its batches are the JAX package's
byte for byte).

Deterministic, seekable, host-shardable: batch i of host h is a pure
function of (seed, step, host) — the property that makes checkpoint/restart
exact (restore step -> identical remaining stream) and lets every host of a
pod produce only its slice without coordination.

The stream is a Zipf-ish unigram mix with short-range repetition structure
(so losses fall during the example runs rather than sitting at ln V), plus
per-sequence ODL "domain" labels (the teacher labels the paper's head
trains on).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_domains: int = 6  # ODL head classes
    seed: int = 0
    n_hosts: int = 1
    host: int = 0


def _domain_unigram(rng: np.random.Generator, vocab: int, n_domains: int):
    """Per-domain Zipf unigram distributions over disjoint-ish preferred sets."""
    base = 1.0 / (np.arange(1, vocab + 1) ** 1.1)
    tables = []
    for d in range(n_domains):
        perm = np.random.default_rng(1000 + d).permutation(vocab)
        p = base[perm]
        tables.append(p / p.sum())
    return np.stack(tables)


class TokenStream:
    def __init__(self, cfg: TokenStreamConfig):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts
        self._tables = _domain_unigram(
            np.random.default_rng(cfg.seed), cfg.vocab_size, cfg.n_domains
        )

    def batch(self, step: int) -> dict:
        """Batch for (step, host): tokens/labels (B_local, S), odl_labels (B_local,)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 64 + cfg.host
        )
        domains = rng.integers(0, cfg.n_domains, size=self.local_batch)
        toks = np.empty((self.local_batch, cfg.seq_len + 1), np.int32)
        for i, d in enumerate(domains):
            seq = rng.choice(cfg.vocab_size, size=cfg.seq_len + 1, p=self._tables[d])
            # Short-range repetition: with p=0.3, copy the token 4 back.
            rep = rng.uniform(size=cfg.seq_len + 1) < 0.3
            rep[:4] = False
            idx = np.arange(cfg.seq_len + 1)
            seq[rep] = seq[idx[rep] - 4]
            toks[i] = seq
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].copy(),
            "odl_labels": domains.astype(np.int32),
        }
