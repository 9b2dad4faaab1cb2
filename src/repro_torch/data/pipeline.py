"""Host-side data pipeline: per-worker token shards -> (W, B, S) batches.

The port's own copy of ``repro/data/pipeline.py`` (``LMShardLoader`` and
``ExtraInputs.frames``): numpy, the same draws in the same order, so the
JAX trainer and the port see identical batches from the same seed.  Each
worker owns a disjoint shard of the corpus.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .synthetic import token_shards


@dataclasses.dataclass
class LMShardLoader:
    n_workers: int
    per_worker_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    tokens_per_worker: int = 0

    def __post_init__(self):
        need = self.per_worker_batch * (self.seq_len + 1) * 64
        self.tokens_per_worker = max(self.tokens_per_worker, need)
        self.shards = token_shards(self.n_workers, self.tokens_per_worker,
                                   self.vocab, self.seed)
        self.rng = np.random.default_rng(self.seed + 1)

    def next_batch(self) -> dict:
        w, b, s = self.n_workers, self.per_worker_batch, self.seq_len
        starts = self.rng.integers(0, self.tokens_per_worker - s - 1,
                                   size=(w, b))
        idx = starts[..., None] + np.arange(s + 1)[None, None]
        window = np.take_along_axis(
            self.shards, idx.reshape(w, b * (s + 1)), axis=1
        ).reshape(w, b, s + 1)
        return {"tokens": window[..., :-1].astype(np.int32),
                "labels": window[..., 1:].astype(np.int32)}


class ExtraInputs:
    """Stubbed modality frontends (audio frames)."""

    @staticmethod
    def frames(n_workers, per_batch, n_frames, d_model, seed=0):
        rng = np.random.default_rng(seed)
        return rng.normal(size=(n_workers, per_batch, n_frames, d_model)
                          ).astype(np.float32)
