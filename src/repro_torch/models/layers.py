"""Layer primitives of the port: RMSNorm, RoPE, causal self-attention,
cross-attention, the gelu MLP, embeddings and the softmax cross-entropy.

Counterpart of ``repro/models/layers.py``.  Parameters keep the JAX
package's layouts (``wq``/``wk``/``wv`` as (d, H, dh), ``wo`` as (H, dh, d),
``w_up`` as (d, ff)), so weights carry across unchanged and the wire order
of the flattened parameters is the same on both sides.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ArchConfig

Tensor = torch.Tensor
NEG_INF = -1e30


def normal(gen: torch.Generator, shape, scale: float, dtype) -> Tensor:
    """scale * N(0, 1) draws from `gen`, on the generator's device."""
    return (torch.randn(shape, generator=gen, device=gen.device) * scale
            ).to(dtype)


# ----------------------------------------------------------------- norms ----
def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """x / rms(x) * (1 + scale), computed in f32 (scale is zero-initialised)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


# ------------------------------------------------------------------ rope ----
def rope_freqs(dh: int, theta: float, device) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=device) / dh))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, Dh); positions: (B, S) or (S,)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention ----
def init_attn(gen: torch.Generator, cfg: ArchConfig, n: int) -> dict:
    """n stacked layers of attention weights, each scaled by 1/sqrt(d)."""
    d, dh, h, kvh = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads
    s = 1.0 / math.sqrt(d)
    dt = cfg.param_dtype
    return {"wq": normal(gen, (n, d, h, dh), s, dt),
            "wk": normal(gen, (n, d, kvh, dh), s, dt),
            "wv": normal(gen, (n, d, kvh, dh), s, dt),
            "wo": normal(gen, (n, h, dh, d), s, dt)}


def proj_out(p: dict, out: Tensor) -> Tensor:
    """(B, S, H, Dh) -> (B, S, d)."""
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))


def _qkv(p: dict, x: Tensor, cfg: ArchConfig, positions: Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def attention(p: dict, x: Tensor, cfg: ArchConfig, positions: Tensor) -> Tensor:
    """Causal self-attention with RoPE (training / prefill).  One query block:
    the JAX package's flash-style blocking changes only the peak memory."""
    q, k, v = _qkv(p, x, cfg, positions)
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) \
        * (1.0 / math.sqrt(dh))
    delta = positions[:, None, None, :, None] - positions[:, None, None, None, :]
    logits = logits.masked_fill(delta < 0, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype), v)
    return proj_out(p, out.reshape(b, sq, h, dh))


def cross_attention(p: dict, x: Tensor, enc: Tensor, cfg: ArchConfig) -> Tensor:
    """Enc-dec cross attention (no RoPE, no mask); the encoder's
    bidirectional self-attention is cross_attention(h, h)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", enc, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", enc, p["wv"].to(x.dtype))
    kvh, h = k.shape[2], q.shape[2]
    b, sq, _, dh = q.shape
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) \
        / math.sqrt(dh)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype), v)
    return proj_out(p, out.reshape(b, sq, h, dh))


# ------------------------------------------------------------------- mlp ----
def init_mlp(gen: torch.Generator, d: int, ff: int, dtype, n: int) -> dict:
    """n stacked layers of the (non-gated) gelu MLP."""
    return {"w_up": normal(gen, (n, d, ff), 1.0 / math.sqrt(d), dtype),
            "w_down": normal(gen, (n, ff, d), 1.0 / math.sqrt(ff), dtype)}


def mlp(p: dict, x: Tensor, activation: str) -> Tensor:
    if activation != "gelu":
        raise NotImplementedError(f"activation {activation!r} is not ported")
    # jax.nn.gelu defaults to the tanh approximation
    up = F.gelu(x @ p["w_up"].to(x.dtype), approximate="tanh")
    return up @ p["w_down"].to(x.dtype)


# ------------------------------------------------------------- embedding ----
def init_embed(gen: torch.Generator, cfg: ArchConfig) -> dict:
    if cfg.tie_embeddings:
        raise NotImplementedError("tied embeddings are not ported")
    dt = cfg.param_dtype
    return {"ln_f": torch.zeros((cfg.d_model,), dtype=dt, device=gen.device),
            "tok": normal(gen, (cfg.vocab, cfg.d_model), 0.02, dt),
            "unembed": normal(gen, (cfg.d_model, cfg.vocab), 0.02, dt)}


def embed(p: dict, tokens: Tensor, cfg: ArchConfig) -> Tensor:
    return F.embedding(tokens.long(), p["tok"]).to(cfg.compute_dtype)


def unembed(p: dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    x = rmsnorm(x, p["ln_f"], cfg.rms_eps)
    return torch.einsum("bsd,dv->bsv", x, p["unembed"].to(x.dtype))


def softmax_xent(logits: Tensor, labels: Tensor) -> Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -torch.mean(ll)
