"""Synthetic data standing in for datasets that cannot be downloaded.

The port's own copy of ``repro/data/synthetic.py:token_shards`` (numpy, the
same draws), so both packages see identical token streams."""
from __future__ import annotations

import numpy as np


def token_shards(n_workers: int, tokens_per_worker: int, vocab: int,
                 seed: int = 0):
    """Zipf-distributed synthetic token stream per worker (for LM demos)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    p = 1.0 / ranks**1.1
    p /= p.sum()
    out = rng.choice(vocab, size=(n_workers, tokens_per_worker), p=p)
    return out.astype(np.int32)
