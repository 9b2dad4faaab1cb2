"""Synthetic data standing in for datasets that cannot be downloaded.

The port's own copy of ``repro/data/synthetic.py`` (numpy, the same draws),
so both packages see identical arrays for the same seed:

* regression_shards: California-housing-like linear regression (20k
  samples, d = 6 correlated features) split across N workers (paper
  Sec. V-A);
* classification_shards: MNIST-like 10-class task (784-dim inputs from
  class prototypes plus structured noise) for Q-SGADMM (Sec. V-B);
* token_shards: Zipf token streams for the LM demos.
"""
from __future__ import annotations

import numpy as np


def regression_shards(n_workers: int = 50, samples: int = 20000, d: int = 6,
                      seed: int = 0, noise: float = 0.1,
                      heterogeneous: bool = True):
    """Returns xs (N, m, d), ys (N, m) and the true weights (d,), float32."""
    rng = np.random.default_rng(seed)
    # correlated feature covariance
    a = rng.normal(size=(d, d))
    cov = a @ a.T / d + 0.5 * np.eye(d)
    chol = np.linalg.cholesky(cov)
    x = rng.normal(size=(samples, d)) @ chol.T
    w_true = rng.normal(size=(d,))
    y = x @ w_true + noise * rng.normal(size=(samples,))
    m = samples // n_workers
    x, y = x[: m * n_workers], y[: m * n_workers]
    if heterogeneous:
        # sort by a feature so shards are non-iid (harder consensus), then
        # interleave lightly so each shard still spans the space
        order = np.argsort(x[:, 0] + 0.3 * rng.normal(size=len(x)))
        x, y = x[order], y[order]
    xs = x.reshape(n_workers, m, d).astype(np.float32)
    ys = y.reshape(n_workers, m).astype(np.float32)
    return xs, ys, w_true.astype(np.float32)


def classification_shards(n_workers: int = 10, samples: int = 6000,
                          dim: int = 784, classes: int = 10, seed: int = 0):
    """MNIST-like synthetic classification: xs (N, m, dim) float32,
    ys (N, m) int32."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(classes, dim)) * 1.5
    # low-rank structured noise (like stroke variation)
    basis = rng.normal(size=(classes, 16, dim))
    labels = rng.integers(0, classes, size=samples)
    coef = rng.normal(size=(samples, 16))
    x = protos[labels] + np.einsum("sk,skd->sd", coef, basis[labels]) * 0.7
    x += 0.8 * rng.normal(size=(samples, dim))
    x = np.tanh(x)  # bounded like pixel intensities
    m = samples // n_workers
    xs = x[: m * n_workers].reshape(n_workers, m, dim).astype(np.float32)
    ys = labels[: m * n_workers].reshape(n_workers, m).astype(np.int32)
    return xs, ys


def token_shards(n_workers: int, tokens_per_worker: int, vocab: int,
                 seed: int = 0):
    """Zipf-distributed synthetic token stream per worker (for LM demos)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    p = 1.0 / ranks**1.1
    p /= p.sum()
    out = rng.choice(vocab, size=(n_workers, tokens_per_worker), p=p)
    return out.astype(np.int32)
