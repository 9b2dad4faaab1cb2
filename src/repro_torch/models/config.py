"""Architecture configuration (the fields the ported model families use).

Counterpart of ``repro/models/config.py:ArchConfig``.  Field names and
defaults follow the JAX package; sharding and TPU-layout knobs are left out.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # ported so far: 'audio' (enc-dec), 'ssm'
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
    ssm: Optional[SSMConfig] = None
    # enc-dec (audio): encoder frames arrive pre-embedded (conv frontend stub)
    encoder_layers: int = 0
    encoder_frames: int = 1500
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def num_params(cfg: ArchConfig) -> int:
    """Analytic parameter count of the ported families; matches the init
    shapes exactly (every leaf, ``ln_f`` included).  The JAX package's count
    leaves out ``ln_f`` and, for the ssm family, each layer's ``conv_b`` and
    ``dt_bias``: 351,744 fewer for mamba2-2.7b."""
    d = cfg.d_model
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2) + d
    if cfg.family == "ssm":
        return emb + cfg.n_layers * (_mamba_params(cfg) + d)
    dh = cfg.dh
    attn = d * (cfg.n_heads * dh) + 2 * d * (cfg.n_kv_heads * dh) \
        + (cfg.n_heads * dh) * d
    mlp = 2 * d * cfg.d_ff
    enc_layer = attn + mlp + 2 * d
    dec_layer = 2 * attn + mlp + 3 * d
    return emb + d + cfg.encoder_layers * enc_layer + cfg.n_layers * dec_layer


def _mamba_params(cfg: ArchConfig) -> int:
    """One mamba2 block's weights (``models/ssm.py:init_mamba``)."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    conv_ch = di + 2 * s.n_groups * s.state_dim
    in_proj = d * (2 * di + 2 * s.n_groups * s.state_dim + nh)
    return in_proj + conv_ch * (s.conv_width + 1) + 3 * nh + di + di * d
