"""Whisper-style encoder-decoder (audio backbone, arXiv:2212.04356).

Counterpart of ``repro/models/encdec.py`` (``init``, ``encode``,
``decode_train``, ``loss_fn``).  The mel/conv frontend is stubbed: the data
pipeline supplies frame embeddings (B, T_enc, d).  Downstream: sinusoid
positions, a bidirectional encoder, a causal RoPE decoder with
cross-attention.  Layers are stacked on a leading n_layers dim, as in the JAX
package, so the flat parameter order (the wire order) is the same.
"""
from __future__ import annotations

import torch

from . import layers as L
from .config import ArchConfig

Tensor = torch.Tensor


def _sinusoid(seq: int, d: int, device) -> Tensor:
    pos = torch.arange(seq, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(0, d, 2, device=device, dtype=torch.float32)[None]
    ang = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random weights from `gen`, on the generator's device."""
    d, dt, dev = cfg.d_model, cfg.param_dtype, gen.device
    ne, nd = cfg.encoder_layers, cfg.n_layers
    zeros = lambda *s: torch.zeros(s, dtype=dt, device=dev)
    return {
        "embed": L.init_embed(gen, cfg),
        "encoder": {
            "attn": L.init_attn(gen, cfg, ne),
            "mlp": L.init_mlp(gen, d, cfg.d_ff, dt, ne),
            "ln1": zeros(ne, d),
            "ln2": zeros(ne, d),
        },
        "enc_ln_f": zeros(d),
        "decoder": {
            "attn": L.init_attn(gen, cfg, nd),
            "xattn": L.init_attn(gen, cfg, nd),
            "mlp": L.init_mlp(gen, d, cfg.d_ff, dt, nd),
            "ln1": zeros(nd, d),
            "lnx": zeros(nd, d),
            "ln2": zeros(nd, d),
        },
    }


def _layer(tree, i: int):
    """Layer i of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def encode(params: dict, frames: Tensor, cfg: ArchConfig) -> Tensor:
    """frames: (B, T_enc, d) pre-embedded (conv frontend stub)."""
    x = frames.to(cfg.compute_dtype)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    for i in range(cfg.encoder_layers):
        blk = _layer(params["encoder"], i)
        h = L.rmsnorm(x, blk["ln1"], cfg.rms_eps)
        x = x + L.cross_attention(blk["attn"], h, h, cfg)
        h = L.rmsnorm(x, blk["ln2"], cfg.rms_eps)
        x = x + L.mlp(blk["mlp"], h, "gelu")
    return L.rmsnorm(x, params["enc_ln_f"], cfg.rms_eps)


def decode_train(params: dict, enc: Tensor, tokens: Tensor,
                 cfg: ArchConfig) -> Tensor:
    x = L.embed(params["embed"], tokens, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for i in range(cfg.n_layers):
        blk = _layer(params["decoder"], i)
        h = L.rmsnorm(x, blk["ln1"], cfg.rms_eps)
        x = x + L.attention(blk["attn"], h, cfg, positions)
        h = L.rmsnorm(x, blk["lnx"], cfg.rms_eps)
        x = x + L.cross_attention(blk["xattn"], h, enc, cfg)
        h = L.rmsnorm(x, blk["ln2"], cfg.rms_eps)
        x = x + L.mlp(blk["mlp"], h, "gelu")
    return x


def loss_fn(params: dict, batch: dict, cfg: ArchConfig) -> Tensor:
    enc = encode(params, batch["frames"], cfg)
    x = decode_train(params, enc, batch["tokens"], cfg)
    logits = L.unembed(params["embed"], x, cfg)
    return L.softmax_xent(logits, batch["labels"])
