"""Mamba2 (SSD — state-space duality, arXiv:2405.21060).

Counterpart of ``repro/models/ssm.py``: the chunked SSD prefill path and the
O(1)-state decode path, with the JAX package's parameter names and stacked
layouts (``{"embed": ..., "blocks": {"mamba": {...}, "ln": (L, d)}}``), so
weights carry across unchanged.  Per chunk of length Q:
  intra-chunk: the masked-decay quadratic term, the SSD kernel
      (``kernels.ssd.ops.ssd_intra``: CUDA on the card, its plain version on
      the CPU), called once per layer and B/C group;
  chunk state: sum_k exp(l_end - l_k) dt_k B_k (x) x_k;
  inter-chunk: a loop over the chunks carrying the (B, H, P, N) state.
Decode carries (conv buffer, SSM state) per layer, constant in the sequence
length.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ssd import ops as ssd_ops
from . import layers as L
from .config import ArchConfig

Tensor = torch.Tensor


# ----------------------------------------------------------- layer params ---
def init_mamba(gen: torch.Generator, cfg: ArchConfig, n: int) -> dict:
    """n stacked mamba2 blocks from `gen`, on the generator's device, with
    the JAX package's distributions: separate z/x/B/C/dt projections scaled
    by 1/sqrt(d), a depthwise conv of N(0, 0.1), A = -linspace(1, 16)."""
    s = cfg.ssm
    d, dt, dev = cfg.d_model, cfg.param_dtype, gen.device
    di = s.d_inner(d)
    nh = s.n_heads(d)
    gn = s.n_groups * s.state_dim
    conv_ch = di + 2 * gn
    scale = 1.0 / math.sqrt(d)

    def const(v):
        return v.to(dtype=dt, device=dev).repeat(n, 1)

    return {
        "w_z": L.normal(gen, (n, d, di), scale, dt),
        "w_x": L.normal(gen, (n, d, di), scale, dt),
        "w_b": L.normal(gen, (n, d, gn), scale, dt),
        "w_c": L.normal(gen, (n, d, gn), scale, dt),
        "w_dt": L.normal(gen, (n, d, nh), scale, dt),
        "conv_w": L.normal(gen, (n, s.conv_width, conv_ch), 0.1, dt),
        "conv_b": const(torch.zeros(conv_ch)),
        "a_log": const(torch.log(torch.linspace(1.0, 16.0, nh))),
        "d_skip": const(torch.ones(nh)),
        "dt_bias": const(torch.zeros(nh)),
        "norm": const(torch.zeros(di)),
        "out_proj": L.normal(gen, (n, di, d), 1.0 / math.sqrt(di), dt),
    }


def _split_proj(p: dict, u: Tensor, cfg: ArchConfig):
    """Returns (z, xbc_preconv_concat, dt_raw)."""
    z = u @ p["w_z"].to(u.dtype)
    x = u @ p["w_x"].to(u.dtype)
    b = u @ p["w_b"].to(u.dtype)
    c = u @ p["w_c"].to(u.dtype)
    dt = u @ p["w_dt"].to(u.dtype)
    return z, torch.cat([x, b, c], dim=-1), dt


def _causal_conv(xbc: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv over time, then silu. xbc: (B, S, C); w: (W, C)."""
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(width):
        out = out + pad[:, i: i + xbc.shape[1], :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :])


def ssd_scan(x: Tensor, dt: Tensor, a_log: Tensor, b: Tensor, c: Tensor,
             chunk: int, init_state: Tensor | None = None):
    """Chunked SSD.  x: (B,S,H,P); dt: (B,S,H); b,c: (B,S,G,N).

    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) f32).  All math
    in f32.  S is padded up to a multiple of Q = min(chunk, S) with dt = 0,
    which leaves the final state unchanged.  The intra-chunk term is the SSD
    kernel, once per group on the group's contiguous heads (h = g*HG + j)."""
    bsz, s, h, pdim = x.shape
    g, n = b.shape[2], b.shape[3]
    hg = h // g
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    f32 = torch.float32
    x_ = x.reshape(bsz, nc, q, h, pdim).to(f32)
    dt_ = dt.reshape(bsz, nc, q, h).to(f32)
    b_ = b.reshape(bsz, nc, q, g, n).to(f32)
    c_ = c.reshape(bsz, nc, q, g, n).to(f32)
    a = -torch.exp(a_log.to(f32))                          # (H,) negative
    la = torch.cumsum(dt_ * a, dim=2)                      # (B,NC,Q,H)

    # intra-chunk: the SSD kernel on B*NC contiguous rows, once per group
    def rows(t, *shape):
        return t.reshape(bsz * nc, q, *shape).contiguous()

    ys = []
    for j in range(g):
        hs = slice(j * hg, (j + 1) * hg)
        ys.append(ssd_ops.ssd_intra(
            rows(x_[:, :, :, hs], hg, pdim), rows(dt_[..., hs], hg),
            rows(la[..., hs], hg), rows(b_[:, :, :, j], n),
            rows(c_[:, :, :, j], n)))
    y_intra = ys[0] if g == 1 else torch.cat(ys, dim=2)
    y_intra = y_intra.reshape(bsz, nc, q, g, hg, pdim)

    # chunk states: S_c = sum_k exp(l_end - l_k) dt_k B_k (x) x_k
    xh = x_.reshape(bsz, nc, q, g, hg, pdim)
    wk = (torch.exp(la[:, :, -1:, :] - la) * dt_).reshape(bsz, nc, q, g, hg)
    s_c = torch.einsum("bckgn,bckghp->bcghpn", b_, xh * wk[..., None])

    # inter-chunk recurrence: the state before each chunk
    chunk_decay = torch.exp(la[:, :, -1, :]).reshape(bsz, nc, g, hg)
    state = (torch.zeros((bsz, g, hg, pdim, n), dtype=f32, device=x.device)
             if init_state is None
             else init_state.reshape(bsz, g, hg, pdim, n).to(f32))
    prev = []
    for i in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, i, :, :, None, None] + s_c[:, i]
    prev_states = torch.stack(prev, dim=1)                 # (B,NC,G,HG,P,N)

    in_decay = torch.exp(la).reshape(bsz, nc, q, g, hg)
    y_inter = torch.einsum("bcqgn,bcghpn->bcqghp", c_, prev_states) \
        * in_decay[..., None]

    y = (y_intra + y_inter).reshape(bsz, nc * q, h, pdim)[:, :s]
    return y.to(x.dtype), state.reshape(bsz, h, pdim, n)


def _block(p: dict, u: Tensor, cfg: ArchConfig,
           init_state: Tensor | None = None):
    """mamba_block's work; returns (out, final state, pre-conv xbc)."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    gn = s.n_groups * s.state_dim
    z, xbc_raw, dt = _split_proj(p, u, cfg)
    xbc = _causal_conv(xbc_raw, p["conv_w"].to(u.dtype),
                       p["conv_b"].to(u.dtype))
    xin = xbc[..., :di]
    b = xbc[..., di: di + gn].reshape(*u.shape[:2], s.n_groups, s.state_dim)
    c = xbc[..., di + gn:].reshape(*u.shape[:2], s.n_groups, s.state_dim)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    xh = xin.reshape(*u.shape[:2], nh, s.head_dim)
    y, state = ssd_scan(xh, dt, p["a_log"], b, c, s.chunk, init_state)
    y = y + xh * p["d_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(*u.shape[:2], di)
    y = L.rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.rms_eps)
    return y @ p["out_proj"].to(y.dtype), state, xbc_raw


def mamba_block(p: dict, u: Tensor, cfg: ArchConfig,
                init_state: Tensor | None = None, return_state: bool = False):
    """Full mamba2 block. u: (B, S, d) -> (B, S, d) (and the final state)."""
    out, state, _ = _block(p, u, cfg, init_state)
    return (out, state) if return_state else out


# ------------------------------------------------------------- decode -------
def mamba_decode(p: dict, u: Tensor, cfg: ArchConfig, conv_buf: Tensor,
                 state: Tensor):
    """One-token step. u: (B, 1, d); conv_buf: (B, W-1, C); state: (B,H,P,N).
    Returns (out (B, 1, d), new conv_buf, new state)."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    gn = s.n_groups * s.state_dim
    f32 = torch.float32
    z, xbc, dt = _split_proj(p, u, cfg)
    window = torch.cat([conv_buf.to(xbc.dtype), xbc], dim=1)       # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", window, p["conv_w"].to(u.dtype)) \
        + p["conv_b"].to(u.dtype)
    conv_out = F.silu(conv_out)[:, None, :]
    new_buf = window[:, 1:]
    xin = conv_out[..., :di]
    b = conv_out[..., di: di + gn].reshape(-1, s.n_groups, s.state_dim)
    c = conv_out[..., di + gn:].reshape(-1, s.n_groups, s.state_dim)
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"].float())       # (B, H)
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt1 * a[None])                                # (B, H)
    xh = xin[:, 0].reshape(-1, nh, s.head_dim).to(f32)
    g, hg = s.n_groups, nh // s.n_groups
    xg = xh.reshape(-1, g, hg, s.head_dim)
    dtg = dt1.reshape(-1, g, hg)
    stg = state.reshape(-1, g, hg, s.head_dim, s.state_dim).to(f32)
    upd = torch.einsum("bgn,bghp->bghpn", b.to(f32), xg * dtg[..., None])
    stg = stg * decay.reshape(-1, g, hg)[..., None, None] + upd
    y = torch.einsum("bgn,bghpn->bghp", c.to(f32), stg)
    y = y.reshape(-1, nh, s.head_dim) \
        + xh * p["d_skip"].to(f32)[None, :, None]
    y = y.reshape(-1, 1, di).to(u.dtype)
    y = L.rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.rms_eps)
    out = y @ p["out_proj"].to(y.dtype)
    return out, new_buf, stg.reshape(-1, nh, s.head_dim, s.state_dim)


# --------------------------------------------------------------- model ------
def _layer(tree, i: int):
    """Layer i of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random weights from `gen`, on the generator's device."""
    return {
        "embed": L.init_embed(gen, cfg),
        "blocks": {
            "mamba": init_mamba(gen, cfg, cfg.n_layers),
            "ln": torch.zeros((cfg.n_layers, cfg.d_model),
                              dtype=cfg.param_dtype, device=gen.device),
        },
    }


def forward(params: dict, tokens: Tensor, cfg: ArchConfig) -> Tensor:
    """tokens (B, S) -> final hidden states (B, S, d) (before ``ln_f``)."""
    x = L.embed(params["embed"], tokens, cfg)
    for i in range(cfg.n_layers):
        blk = _layer(params["blocks"], i)
        h = L.rmsnorm(x, blk["ln"], cfg.rms_eps)
        x = x + mamba_block(blk["mamba"], h, cfg)
    return x


def loss_fn(params: dict, batch: dict, cfg: ArchConfig) -> Tensor:
    x = forward(params, batch["tokens"], cfg)
    logits = L.unembed(params["embed"], x, cfg)
    return L.softmax_xent(logits, batch["labels"])


def init_cache(cfg: ArchConfig, batch: int, max_seq: int = 0, dtype=None,
               device=None) -> dict:
    """SSM 'cache' = conv buffer + state per layer; independent of max_seq."""
    dtype = dtype or cfg.compute_dtype
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    conv_ch = di + 2 * s.n_groups * s.state_dim
    return {
        "conv": torch.zeros((cfg.n_layers, batch, s.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "state": torch.zeros((cfg.n_layers, batch, nh, s.head_dim,
                              s.state_dim), dtype=torch.float32,
                             device=device),
    }


def prefill(params: dict, tokens: Tensor, cfg: ArchConfig):
    """tokens (B, S >= W-1) -> (last-token logits (B, vocab), cache).  The
    conv tail of the cache is the last W-1 pre-conv projections of each
    layer, copied from the block's own projection (the JAX package
    recomputes it) into the preallocated cache, so no layer's whole
    projection outlives the layer."""
    x = L.embed(params["embed"], tokens, cfg)
    tail = cfg.ssm.conv_width - 1
    cache = init_cache(cfg, tokens.shape[0], dtype=x.dtype, device=x.device)
    for i in range(cfg.n_layers):
        blk = _layer(params["blocks"], i)
        h = L.rmsnorm(x, blk["ln"], cfg.rms_eps)
        out, cache["state"][i], xbc = _block(blk["mamba"], h, cfg)
        cache["conv"][i] = xbc[:, -tail:, :]
        x = x + out
    logits = L.unembed(params["embed"], x[:, -1:], cfg)[:, 0]
    return logits, cache


def decode_step(params: dict, token: Tensor, cache: dict, pos: Tensor,
                cfg: ArchConfig):
    """token (B,) -> (logits (B, vocab), the next cache, a new dict: the
    given one is left as it was).  `pos` is unused: the state carries the
    position."""
    x = L.embed(params["embed"], token[:, None], cfg)
    new = {k: torch.empty_like(v) for k, v in cache.items()}
    for i in range(cfg.n_layers):
        blk = _layer(params["blocks"], i)
        h = L.rmsnorm(x, blk["ln"], cfg.rms_eps)
        out, new["conv"][i], new["state"][i] = mamba_decode(
            blk["mamba"], h, cfg, cache["conv"][i], cache["state"][i])
        x = x + out
    logits = L.unembed(params["embed"], x, cfg)[:, 0]
    return logits, new
