"""Architecture configuration (the fields the ported model families use).

Counterpart of ``repro/models/config.py:ArchConfig``.  Field names and
defaults follow the JAX package; sharding and TPU-layout knobs are left out.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # only 'audio' (enc-dec) is ported so far
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 => d_model // n_heads
    activation: str = "silu"
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    # enc-dec (audio): encoder frames arrive pre-embedded (conv frontend stub)
    encoder_layers: int = 0
    encoder_frames: int = 1500
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def num_params(cfg: ArchConfig) -> int:
    """Analytic parameter count of the audio family (matches init shapes)."""
    d, dh = cfg.d_model, cfg.dh
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2) + d
    attn = d * (cfg.n_heads * dh) + 2 * d * (cfg.n_kv_heads * dh) \
        + (cfg.n_heads * dh) * d
    mlp = 2 * d * cfg.d_ff
    enc_layer = attn + mlp + 2 * d
    dec_layer = 2 * attn + mlp + 3 * d
    return emb + d + cfg.encoder_layers * enc_layer + cfg.n_layers * dec_layer
