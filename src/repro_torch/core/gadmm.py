"""GADMM and Q-GADMM for convex objectives on a worker chain (Algorithm 1),
and the same sweep on any connected bipartite graph with censoring
(CQ-GGADMM).

Counterpart of ``repro/core/gadmm.py`` (paper eqs. 14-18): per iteration
the heads (chain positions 0, 2, ...) solve their local problems against
the neighbours' reconstructed models, quantize theta - hat and transmit;
then the tails do the same with the heads' fresh hats; then every dual
takes lam += alpha * rho * (hat_n - hat_{n+1}).  The local problems are
quadratics f_n(t) = 0.5 ||X_n t - y_n||^2, solved in closed form with the
inverse factored once (``make_quadratic``).

Each quantized phase is one launch of the codec (K1) over all N rows, with
one radius and one width per row; every row is coded and only the active
rows commit, as in the JAX function.  With ``cfg.quantize=False`` (GADMM)
no codec runs and hat = theta.  The rounding draws are passed in (``u``) or
drawn from the state's generator on the state's device.  States are
float32; a float64 one raises ``TypeError`` (``quantizer.require_f32``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import generator, resolve_device
from ..kernels.quantize import ops as q_ops
from .censor import FLAG_BITS, transmit_mask
from .quantizer import (QuantizerConfig, _next_bits, header_bits, levels_of,
                        require_f32)
from .topology import edge_index

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GADMMConfig:
    """rho: augmented-Lagrangian penalty; quantize: send quantized hats (Q-GADMM)
    or full precision (GADMM); qcfg: the quantizer; alpha: dual damping (the
    paper uses 1 for convex problems, 0.01 for DNNs); topk_frac: fraction of
    coordinates sent per round (1.0 = dense; unsent coordinates keep their
    old hat, so their residual is sent later)."""

    rho: float = 24.0
    quantize: bool = True
    qcfg: QuantizerConfig = QuantizerConfig(bits=2)
    alpha: float = 1.0
    topk_frac: float = 1.0


class ChainState(NamedTuple):
    theta: Tensor      # (N, d) current primal variables
    theta_hat: Tensor  # (N, d) last quantized model of every worker
    lam: Tensor        # (N+1, d) duals; lam[0] == lam[N] == 0 always
    radius: Tensor     # (N,) R_n^{k-1}
    bits: Tensor       # (N,) int32 b_n^{k-1}
    gen: torch.Generator  # rounding draws, on the state's device
    step: int


def init_state(n: int, d: int, cfg: GADMMConfig, seed: int = 0,
               device=None) -> ChainState:
    dev = resolve_device(device)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    return ChainState(
        theta=z(n, d), theta_hat=z(n, d), lam=z(n + 1, d), radius=z(n),
        bits=torch.full((n,), cfg.qcfg.bits, dtype=torch.int32, device=dev),
        gen=generator(seed, dev), step=0)


class Quadratic(NamedTuple):
    """Per-worker quadratic local objectives, pre-factorized."""

    xtx: Tensor   # (N, d, d)
    xty: Tensor   # (N, d)
    minv: Tensor  # (N, d, d): inverse of (xtx + c_n rho I), c_n = #neighbors

    def objective(self, theta: Tensor) -> Tensor:
        """F(theta) = sum_n 0.5 theta_n^T XtX_n theta_n - xty_n . theta_n
        (the constant 0.5 ||y||^2 left out)."""
        quad = 0.5 * torch.einsum("nd,nde,ne->", theta, self.xtx, theta)
        lin = torch.einsum("nd,nd->", theta, self.xty)
        return quad - lin


def _factor(xtx: Tensor, cn: Tensor, rho: float) -> Tensor:
    eye = torch.eye(xtx.shape[-1], dtype=xtx.dtype, device=xtx.device)
    return torch.linalg.inv(xtx + rho * cn[:, None, None] * eye[None])


def _chain_degree(n: int, device) -> Tensor:
    idx = torch.arange(n, device=device)
    return torch.where((idx == 0) | (idx == n - 1), 1.0, 2.0)


def make_quadratic(xs: Tensor, ys: Tensor, rho: float) -> Quadratic:
    """xs: (N, m, d) worker design matrices, ys: (N, m), float32."""
    require_f32(xs, ys)
    xtx = torch.einsum("nmd,nme->nde", xs, xs)
    xty = torch.einsum("nmd,nm->nd", xs, ys)
    return Quadratic(xtx=xtx, xty=xty,
                     minv=_factor(xtx, _chain_degree(xs.shape[0], xs.device),
                                  rho))


def _solve(q: Quadratic, rhs: Tensor) -> Tensor:
    """minv_n @ rhs_n for every worker: one batched product (full float32
    with TF32 off; it sums in another order than XLA's dot, so the
    solution is a few ulp from the JAX package's)."""
    return torch.einsum("nde,ne->nd", q.minv, rhs)


def _solve_all(q: Quadratic, lam: Tensor, hat: Tensor, rho: float) -> Tensor:
    """Closed-form local argmin for every worker given the duals and hats."""
    n = hat.shape[0]
    idx = torch.arange(n, device=hat.device)
    hat_left = torch.roll(hat, 1, dims=0) * (idx > 0)[:, None]
    hat_right = torch.roll(hat, -1, dims=0) * (idx < n - 1)[:, None]
    rhs = q.xty + lam[:-1] - lam[1:] + rho * (hat_left + hat_right)
    return _solve(q, rhs)


def dequantize_rows(qlev: Tensor, hat_prev: Tensor, radius: Tensor,
                    bits: Tensor) -> Tensor:
    """Receiver-side reconstruction of per-row payloads (eq. 13): the
    sender's float32 operations, so both ends of a link agree bitwise.
    qlev: (..., d) levels, hat_prev: (..., d), radius / bits: (...,)."""
    return q_ops.decode_ref(hat_prev, qlev, radius[..., None],
                            levels_of(bits)[..., None])


def quantize_rows(theta: Tensor, hat_prev: Tensor, active: Tensor, u,
                  radius_prev: Tensor, bits_prev: Tensor, cfg: GADMMConfig):
    """Stochastically quantize every row in one codec launch; commit the
    active rows.

    u: the (N, d) float32 uniform draw (unused, and may be None, when
    ``cfg.quantize`` is False).  Returns (hat, radius, bits, qlev): qlev is
    the (N, d) uint8 wire payload (None without quantization), and hat its
    reconstruction (``dequantize_rows`` of it gives the same bits).  Row n
    of every output depends only on row n of the inputs."""
    require_f32(theta, hat_prev)
    n, d = theta.shape
    diff = theta - hat_prev
    r_new = torch.amax(torch.abs(diff), dim=1)      # (N,) per-worker inf-norm
    b_new = _next_bits(cfg.qcfg, bits_prev, r_new, radius_prev).expand(n)
    qlev = None
    if cfg.quantize:
        qlev, hat_new = q_ops.quantize_dequantize(
            theta, hat_prev, torch.as_tensor(u, device=theta.device),
            r_new, levels_of(b_new))
        if cfg.topk_frac < 1.0:
            # exactly the k largest |delta| coordinates are sent (ties by
            # index, as lax.top_k and the billed k); the rest keep the
            # receiver's (== sender's) previous hat
            k = max(int(d * cfg.topk_frac), 1)
            top = torch.argsort(torch.abs(diff), dim=1, descending=True,
                                stable=True)[:, :k]
            sent = torch.zeros((n, d), dtype=torch.bool, device=theta.device)
            sent.scatter_(1, top, True)
            hat_new = torch.where(sent, hat_new, hat_prev)
    else:
        hat_new = theta      # GADMM: full-precision "transmission"
    hat = torch.where(active[:, None], hat_new, hat_prev)
    return (hat, torch.where(active, r_new, radius_prev),
            torch.where(active, b_new, bits_prev), qlev)


def _quantize_rows(theta, hat_prev, active, u, radius_prev, bits_prev, cfg):
    """quantize_rows without the wire payload (chain / sgadmm call sites)."""
    return quantize_rows(theta, hat_prev, active, u, radius_prev, bits_prev,
                         cfg)[:3]


def _draws(gen: torch.Generator, shape, u, cfg: GADMMConfig, device):
    """The two phases' (N, d) draws: `u` as given, else from `gen` (none
    without quantization)."""
    if not cfg.quantize:
        return None, None
    if u is not None:
        return tuple(torch.as_tensor(x, dtype=torch.float32, device=device)
                     for x in u)
    return tuple(torch.rand(shape, generator=gen, device=device)
                 for _ in range(2))


def _chain_dual_update(lam: Tensor, hat: Tensor, cfg: GADMMConfig) -> Tensor:
    """eq. 18 on the chain's N - 1 links; lam[0] and lam[N] stay 0."""
    lam = lam.clone()
    lam[1:-1] += cfg.alpha * cfg.rho * (hat[:-1] - hat[1:])
    lam[0] = 0.0
    lam[-1] = 0.0
    return lam


def gadmm_step(state: ChainState, q: Quadratic, cfg: GADMMConfig,
               u=None) -> ChainState:
    """One full iteration (heads phase + tails phase + dual update).
    u: optional pair of (N, d) float32 draws for the two phases."""
    n = state.theta.shape[0]
    dev = state.theta.device
    is_head = (torch.arange(n, device=dev) % 2) == 0
    u_h, u_t = _draws(state.gen, state.theta.shape, u, cfg, dev)

    # heads phase
    theta_all = _solve_all(q, state.lam, state.theta_hat, cfg.rho)
    theta = torch.where(is_head[:, None], theta_all, state.theta)
    hat, radius, bits = _quantize_rows(
        theta, state.theta_hat, is_head, u_h, state.radius, state.bits, cfg)
    # tails phase, with the heads' fresh hats
    theta_all = _solve_all(q, state.lam, hat, cfg.rho)
    theta = torch.where(is_head[:, None], theta, theta_all)
    hat, radius, bits = _quantize_rows(theta, hat, ~is_head, u_t, radius,
                                       bits, cfg)
    return ChainState(theta=theta, theta_hat=hat,
                      lam=_chain_dual_update(state.lam, hat, cfg),
                      radius=radius, bits=bits, gen=state.gen,
                      step=state.step + 1)


def rechain(state: ChainState, perm) -> ChainState:
    """Time-varying topology: `perm[i]` = worker that moves to chain position
    i.  Primal and quantizer state travel with the worker; the
    position-bound edge duals are reset (an ADMM restart)."""
    perm = torch.as_tensor(np.asarray(perm), device=state.theta.device)
    return state._replace(theta=state.theta[perm],
                          theta_hat=state.theta_hat[perm],
                          lam=torch.zeros_like(state.lam),
                          radius=state.radius[perm], bits=state.bits[perm])


def rechain_quadratic(q: Quadratic, perm, rho: float) -> Quadratic:
    """Permute the per-position objectives for a new chain order and refactor
    (endpoints c_n = 1, interior c_n = 2)."""
    perm = torch.as_tensor(np.asarray(perm), device=q.xtx.device)
    xtx, xty = q.xtx[perm], q.xty[perm]
    return Quadratic(xtx=xtx, xty=xty,
                     minv=_factor(xtx, _chain_degree(xty.shape[0],
                                                     xtx.device), rho))


def residuals(state: ChainState) -> tuple[Tensor, Tensor]:
    """Primal residual ||theta_n - theta_{n+1}|| and its max entry."""
    r = state.theta[:-1] - state.theta[1:]
    return torch.sqrt(torch.sum(r * r)), torch.amax(torch.abs(r))


def _payload_bits_per_worker(cfg: GADMMConfig, d: int) -> int:
    """Bits of one worker's broadcast payload (chain and graph accounting)."""
    if not cfg.quantize:
        return 32 * d
    header = header_bits(cfg.qcfg.adapt_bits)
    if cfg.topk_frac < 1.0:
        k = max(int(d * cfg.topk_frac), 1)
        idx_bits = max(int(math.ceil(math.log2(max(d, 2)))), 1)
        return k * (cfg.qcfg.bits + idx_bits) + header
    return cfg.qcfg.bits * d + header


def bits_per_round(cfg: GADMMConfig, n: int, d: int) -> int:
    """Bits all N workers transmit in one iteration: N * (b*d + 64) for
    Q-GADMM, N * 32 d for GADMM."""
    return n * _payload_bits_per_worker(cfg, d)


# ===== any bipartite topology, censored transmissions (CQ-GGADMM) =========


class GraphState(NamedTuple):
    theta: Tensor      # (N, d) current primals
    theta_hat: Tensor  # (N, d) last transmitted quantized models
    lam: Tensor        # (E, d) edge duals, canonical head -> tail
    radius: Tensor     # (N,) R_n of the last transmitted round
    bits: Tensor       # (N,) int32 b_n of the last transmitted round
    sent: Tensor       # (N,) bool: did worker n transmit last iteration?
    gen: torch.Generator
    step: int


def graph_init_state(topo, d: int, cfg: GADMMConfig, seed: int = 0,
                     device=None) -> GraphState:
    dev = resolve_device(device)
    n = topo.n
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    return GraphState(
        theta=z(n, d), theta_hat=z(n, d), lam=z(topo.num_edges, d),
        radius=z(n),
        bits=torch.full((n,), cfg.qcfg.bits, dtype=torch.int32, device=dev),
        sent=torch.zeros((n,), dtype=torch.bool, device=dev),
        gen=generator(seed, dev), step=0)


def make_graph_quadratic(xs: Tensor, ys: Tensor, rho: float,
                         topo) -> Quadratic:
    """Per-worker quadratics factored with c_n = deg(n) of the topology."""
    require_f32(xs, ys)
    assert xs.shape[0] == topo.n, (xs.shape[0], topo.n)
    xtx = torch.einsum("nmd,nme->nde", xs, xs)
    xty = torch.einsum("nmd,nm->nd", xs, ys)
    cn = torch.as_tensor(topo.degree, dtype=torch.float32, device=xs.device)
    return Quadratic(xtx=xtx, xty=xty, minv=_factor(xtx, cn, rho))


def graph_consts(topo, layout: str = "edge", device=None) -> dict:
    """The topology's tables on `device`, built once per run.

    ``nbr_src`` / ``nbr_edge``: (N, C) padded tables of each worker's
    incoming directed edges in ascending source order (from
    ``edge_index``'s (dst, src)-sorted arrays; padding points at an
    appended zero row), so the neighbour sums add each worker's terms one
    column at a time in that order — the order of the JAX package's sorted
    ``segment_sum`` — deterministically on the card, where ``index_add_``
    is atomic.  ``layout='port'`` also builds the dense operators ``adj``
    (N, N) and ``inc`` (N, E), kept as the comparator."""
    assert layout in ("edge", "port"), layout
    dev = resolve_device(device)
    n, ne = topo.n, topo.num_edges
    eidx = edge_index(topo)
    counts = np.bincount(eidx.dst, minlength=n)
    c_max = int(counts.max()) if ne else 0
    start = np.cumsum(counts) - counts
    col = np.arange(len(eidx.dst)) - start[eidx.dst]
    nbr_src = np.full((n, c_max), n, np.int64)
    nbr_edge = np.full((n, c_max), ne, np.int64)
    nbr_src[eidx.dst, col] = eidx.src
    nbr_edge[eidx.dst, col] = eidx.edge
    edges = topo.edges if ne else np.zeros((0, 2), np.int64)
    as_t = lambda a: torch.as_tensor(a, device=dev)
    tc = dict(head=as_t(topo.head_mask), e_head=as_t(edges[:, 0]),
              e_tail=as_t(edges[:, 1]), n=n, nbr_src=as_t(nbr_src),
              nbr_edge=as_t(nbr_edge), adj=None, inc=None)
    if layout == "port":
        inc = np.zeros((n, max(ne, 1)), np.float32)
        for e, (h, t) in enumerate(edges):
            inc[h, e] = inc[t, e] = 1.0
        tc["adj"] = as_t(topo.adjacency().astype(np.float32))
        tc["inc"] = as_t(inc)
    return tc


def _ordered_sum(rows: Tensor, table: Tensor) -> Tensor:
    """out[w] = sum over c of rows[table[w, c]], added in column order from
    zero; `table` pads with len(rows), which reads an appended zero row."""
    padded = torch.cat([rows, torch.zeros_like(rows[:1])])
    g = padded[table]                                    # (N, C, d)
    out = torch.zeros((table.shape[0], rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    for c in range(table.shape[1]):
        out = out + g[:, c]
    return out


def _graph_solve_all(q: Quadratic, lam: Tensor, hat: Tensor, rho: float,
                     tc: dict, layout: str = "edge") -> Tensor:
    """Closed-form local argmin for every worker on the graph:
    (XtX + deg_n rho I) theta_n = Xty_n - s_n sum_e lam_e
    + rho sum_nbr hat_nbr, with s_n = +1 for heads (duals are oriented
    head -> tail)."""
    sign = torch.where(tc["head"], 1.0, -1.0)[:, None]
    if layout == "port":
        assert tc["adj"] is not None, \
            "layout='port' needs graph_consts(topo, layout='port')"
        lam_sum = tc["inc"] @ lam if lam.shape[0] else torch.zeros_like(hat)
        nbr_sum = tc["adj"] @ hat
    else:
        assert layout == "edge", layout
        if lam.shape[0]:
            lam_sum = _ordered_sum(lam, tc["nbr_edge"])
            nbr_sum = _ordered_sum(hat, tc["nbr_src"])
        else:   # W = 1: no edges, no neighbour terms
            lam_sum = torch.zeros_like(hat)
            nbr_sum = torch.zeros_like(hat)
    rhs = q.xty - sign * lam_sum + rho * nbr_sum
    return _solve(q, rhs)


def graph_phase(theta: Tensor, hat: Tensor, lam: Tensor, radius: Tensor,
                bits: Tensor, active: Tensor, u, *, q: Quadratic,
                cfg: GADMMConfig, tc: dict, step: int, censor=None,
                layout: str = "edge"):
    """One phase of the graph sweep: the `active` group solves, quantizes
    (one codec launch over all rows) and, with `censor`, keeps silent where
    its hat moved less than tau * xi^step (it and its neighbours keep the
    previous hat).  Returns (theta, hat, radius, bits, sent, qlev); row n
    depends only on row n, n's neighbour rows of `hat` and n's incident
    rows of `lam`."""
    theta_all = _graph_solve_all(q, lam, hat, cfg.rho, tc, layout=layout)
    theta = torch.where(active[:, None], theta_all, theta)
    hat_new, r_new, b_new, qlev = quantize_rows(theta, hat, active, u, radius,
                                                bits, cfg)
    if censor is not None:
        sent = active & transmit_mask([hat_new], [hat], censor, step)
        hat_new = torch.where(sent[:, None], hat_new, hat)
        r_new = torch.where(sent, r_new, radius)
        b_new = torch.where(sent, b_new, bits)
    else:
        sent = active
    return theta, hat_new, r_new, b_new, sent, qlev


def graph_dual_update(lam: Tensor, hat: Tensor, cfg: GADMMConfig, tc: dict,
                      edge_mask: Tensor | None = None) -> Tensor:
    """Per-edge damped dual update (eq. 18): lam_e += a*rho*(h_head - h_tail);
    `edge_mask` (E,) freezes the edges where it is 0."""
    if not lam.shape[0]:
        return lam
    resid = hat[tc["e_head"]] - hat[tc["e_tail"]]
    if edge_mask is not None:
        resid = resid * edge_mask[:, None]
    return lam + cfg.alpha * cfg.rho * resid


def graph_step(state: GraphState, q: Quadratic, cfg: GADMMConfig, topo,
               censor=None, layout: str = "edge", u=None,
               tc: dict | None = None) -> GraphState:
    """One (censored) GGADMM / CQ-GGADMM iteration on a bipartite topology:
    heads phase, tails phase, per-edge dual update.  u: optional pair of
    (N, d) draws; tc: ``graph_consts(topo, layout)`` on the state's device,
    built here when not given (build it once for a run)."""
    dev = state.theta.device
    if tc is None:
        tc = graph_consts(topo, layout=layout, device=dev)
    is_head = tc["head"]
    u_h, u_t = _draws(state.gen, state.theta.shape, u, cfg, dev)
    theta, hat, radius, bits, sent_h, _ = graph_phase(
        state.theta, state.theta_hat, state.lam, state.radius, state.bits,
        is_head, u_h, q=q, cfg=cfg, tc=tc, step=state.step, censor=censor,
        layout=layout)
    theta, hat, radius, bits, sent_t, _ = graph_phase(
        theta, hat, state.lam, radius, bits, ~is_head, u_t, q=q, cfg=cfg,
        tc=tc, step=state.step, censor=censor, layout=layout)
    return GraphState(theta=theta, theta_hat=hat,
                      lam=graph_dual_update(state.lam, hat, cfg, tc),
                      radius=radius, bits=bits, sent=sent_h | sent_t,
                      gen=state.gen, step=state.step + 1)


def graph_bits_per_round(cfg: GADMMConfig, topo, d: int, sent=None,
                         censored: bool = False):
    """Bits all workers broadcast in one graph iteration.  Uncensored: an
    int, every worker's payload.  Censored: a float32 scalar tensor, the
    payload of each worker with sent=True plus FLAG_BITS for every
    worker."""
    per = _payload_bits_per_worker(cfg, d)
    if not censored:
        return topo.n * per
    assert sent is not None, "censored accounting needs the sent mask"
    return torch.sum(sent.to(torch.float32)) * per + topo.n * FLAG_BITS
