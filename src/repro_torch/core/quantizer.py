"""Stochastic quantizer of Q-GADMM (paper eqs. 6-13): configuration, the
eq. 11 bit-growth rule, the per-leaf (layerwise) tables and the bit-budget
controller, and payload accounting.

Worker n quantizes the difference between its model and its previous hat:

    R      = ||theta - theta_hat_prev||_inf
    Delta  = 2 R / (2^b - 1)
    q_i    = stochastic rounding of (theta_i - theta_hat_prev_i + R) / Delta
    theta_hat = theta_hat_prev + Delta * q - R

The arithmetic itself is the codec kernel (``repro_torch.kernels.quantize``,
K1 for one radius per tensor or row); the receiver decodes with the same
float32 operations (``decode_ref``), so both ends stay bitwise equal.
Counterpart of ``repro/core/quantizer.py``.  Trees are nested dicts of
tensors, taken in the JAX leaf order (``repro_torch.tree``).  The codec
reads float32 and bfloat16 only: a float64 tensor raises ``TypeError``
(``require_f32``), never silently rounds.

The float32 rules here reproduce the jitted JAX functions bit for bit, so a
run makes the same bit-width decisions as the reference: XLA contracts
``1 + levels * ratio`` into one fused multiply-add and turns ``log2`` into
``log(x) * f32(1 / f32(ln 2))``, and both are written that way below.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..kernels.quantize import ops as q_ops
from ..tree import _set, leaves_with_path, map_leaves

Tensor = torch.Tensor

#: where the float64 codec variant is queued (the JAX benchmarks of the
#: paper's linear regression run with ``jax_enable_x64``)
F64_ITEM = "ROADMAP Queue 1 item 11"

# XLA's log2(x): log(x) times the float32 reciprocal of float32(ln 2)
_INV_LN2 = float(np.float32(1.0) / np.float32(math.log(2.0)))


@dataclasses.dataclass(frozen=True)
class QuantizerConfig:
    """bits: quantizer resolution b (levels = 2^b - 1 intervals).
    adapt_bits: apply the bit-growth rule (eq. 11) that keeps Delta_n^k
    non-increasing.  max_bits: cap for adaptive bits (<= 8: one byte per
    level on the wire)."""

    bits: int = 2
    adapt_bits: bool = False
    max_bits: int = 8

    def __post_init__(self):
        assert 1 <= self.bits <= self.max_bits <= 8


@dataclasses.dataclass(frozen=True)
class LayerwiseConfig:
    """Per-leaf (L-FGADMM, arXiv:1911.03654) quantization knobs; the JAX
    package's fields and meaning (``repro/core/quantizer.py``).

    bits: per-leaf base widths (int, length-L tuple in leaf order, or None
    for QuantizerConfig.bits).  periods: per-leaf exchange periods (leaf l
    is sent only when step % periods[l] == 0).  large_leaf_period /
    large_leaf_frac: size rule for the CLI (a leaf holding at least that
    fraction of the parameters gets that period; an explicit tuple wins).
    taus / tau_xi: per-leaf censor thresholds taus[l] * tau_xi**step on the
    leaf's L2 delta.  adapt_bits: eq. 11 per leaf.  budget_bits: per-worker
    payload budget of the controller (``allocate_bits``), superseding the
    static / eq. 11 widths.  min_bits / max_bits: controller range and
    eq. 11 cap."""

    bits: Any = None
    periods: Any = 1
    large_leaf_period: int = 1
    large_leaf_frac: float = 0.5
    taus: Any = None
    tau_xi: float = 1.0
    adapt_bits: bool = False
    budget_bits: int | None = None
    min_bits: int = 1
    max_bits: int = 8

    def __post_init__(self):
        assert 1 <= self.min_bits <= self.max_bits <= 8
        assert self.large_leaf_period >= 1
        assert 0.0 < self.large_leaf_frac <= 1.0
        assert 0.0 < self.tau_xi <= 1.0
        assert self.budget_bits is None or self.budget_bits > 0
        for name in ("bits", "periods"):
            v = getattr(self, name)
            if isinstance(v, int):
                assert v >= 1, (name, v)
            elif v is not None:
                assert all(int(b) >= 1 for b in v), (name, v)
        if isinstance(self.bits, int):
            assert self.bits <= self.max_bits

    @staticmethod
    def _expand(value, n: int, default) -> list:
        if value is None:
            value = default
        if isinstance(value, (int, float)):
            return [value] * n
        assert len(value) == n, (
            f"layerwise field of length {len(value)} vs {n} leaves")
        return list(value)

    def resolve(self, sizes, base_bits: int):
        """(bits, periods, taus) for flat leaf sizes `sizes`: int lists of
        length L (taus a float list, or None without per-leaf censoring)."""
        n = len(sizes)
        bits = [int(b) for b in self._expand(self.bits, n, base_bits)]
        assert all(1 <= b <= self.max_bits for b in bits), bits
        periods = [int(p) for p in self._expand(self.periods, n, 1)]
        if self.large_leaf_period > 1 and not isinstance(
                self.periods, (tuple, list)):
            total = max(sum(sizes), 1)
            periods = [self.large_leaf_period
                       if s >= self.large_leaf_frac * total else p
                       for p, s in zip(periods, sizes)]
        taus = (None if self.taus is None
                else [float(t) for t in self._expand(self.taus, n, 0.0)])
        return bits, periods, taus


def levels_of(bits: Tensor) -> Tensor:
    """2^b - 1 as float32, exact (integer power, then one conversion)."""
    return (2 ** bits.to(torch.int32)).to(torch.float32) - 1.0


def allocate_bits(scores: Tensor, sizes, budget_bits: int, min_bits: int,
                  max_bits: int) -> Tensor:
    """Bit-budget controller: every leaf gets min_bits, then the budget
    left upgrades leaves in strict score order (stable on ties), each as far
    as the budget left after fully upgrading every better-ranked leaf
    allows.

    scores: (..., L) per-leaf ranking scores; sizes: (L,) element counts.
    Returns (..., L) int32 widths in [min_bits, max_bits].  float32 as in
    the JAX function; the prefix sums are taken exactly and rounded once
    to float32, which is what the reference's float32 scan gives whenever
    its partial sums are exact (leaf sizes that are multiples of 2^k with
    span * sum(sizes) < 2^(24+k): whisper-tiny's are multiples of 128)."""
    scores = scores.to(torch.float32)
    sizes = torch.as_tensor(np.asarray(sizes, np.float32),
                            device=scores.device)
    span = float(max_bits - min_bits)
    total = sizes.double().sum().to(torch.float32)
    avail = torch.clamp_min(float(budget_bits) - float(min_bits) * total, 0.0)
    order = torch.argsort(-scores, dim=-1, stable=True)       # best first
    size_sorted = sizes.expand(scores.shape).gather(-1, order)
    cost_sorted = span * size_sorted
    spent_before = (torch.cumsum(cost_sorted.double(), dim=-1)
                    .to(torch.float32) - cost_sorted)
    room = torch.clamp_min(avail - spent_before, 0.0)
    add_sorted = torch.clamp(
        torch.floor(room / torch.clamp_min(size_sorted, 1.0)), 0.0, span)
    add = torch.empty_like(add_sorted).scatter_(-1, order, add_sorted)
    return (min_bits + add).to(torch.int32)


def _next_bits(cfg: QuantizerConfig, bits_prev: Tensor, r_new: Tensor,
               r_prev: Tensor, base_bits=None) -> Tensor:
    """Bit-growth rule (eq. 11): the smallest b with Delta^k <= Delta^{k-1},
    elementwise over broadcast-compatible (bits_prev, r_new, r_prev).
    Where r_prev == 0 (nothing sent yet) it falls back to `base_bits`
    (cfg.bits when None)."""
    base = torch.as_tensor(cfg.bits if base_bits is None else base_bits,
                           dtype=torch.int32, device=r_new.device)
    if not cfg.adapt_bits:
        return base.expand(torch.broadcast_shapes(base.shape, r_new.shape))
    levels_prev = levels_of(bits_prev)
    ratio = torch.where(r_prev > 0, r_new / torch.clamp_min(r_prev, 1e-30),
                        0.0)
    # one rounding of 1 + levels * ratio (the product is exact in float64)
    x = (1.0 + levels_prev.double() * ratio.double()).to(torch.float32)
    needed = torch.ceil(torch.log(x) * _INV_LN2)
    b = torch.clamp(needed.to(torch.int32), 1, cfg.max_bits)
    return torch.where(r_prev > 0, b, base)


def require_f32(*tensors: Tensor) -> None:
    """Raise TypeError unless every tensor is float32 (the states of the
    chain, graph and SGADMM solvers, and the PS baselines' gradients)."""
    for t in tensors:
        if t.dtype == torch.float32:
            continue
        if t.dtype == torch.float64:
            raise TypeError(
                "float64 state: the codec computes in float32 (as its TPU "
                f"original does); a float64 codec variant is {F64_ITEM}")
        raise TypeError(f"expected a float32 state, got {t.dtype}")


@dataclasses.dataclass
class QuantState:
    """Carried across iterations for one worker's tree: the previously
    quantized model, R^{k-1} (f32 scalar) and b^{k-1} (int32 scalar)."""

    theta_hat: Any
    radius: Tensor
    bits: Tensor


def init_state(theta, cfg: QuantizerConfig) -> QuantState:
    """Quantizer state at k = 0: theta_hat = 0 (the paper starts from
    theta^0 = 0), on the device of theta's leaves."""
    dev = leaves_with_path(theta)[0][1].device
    return QuantState(theta_hat=map_leaves(torch.zeros_like, theta),
                      radius=torch.zeros((), dtype=torch.float32, device=dev),
                      bits=torch.tensor(cfg.bits, dtype=torch.int32,
                                        device=dev))


def quantize_tensor(theta: Tensor, theta_hat_prev: Tensor, draw, *,
                    radius: Tensor, bits: Tensor) -> tuple[Tensor, Tensor]:
    """Quantize one tensor given a scalar radius and bit width, through the
    codec (one K1 launch on the card).

    draw: the uniform draw u (f32, theta's shape) or a ``torch.Generator``
    on theta's device to draw it from.  Returns (q uint8, new hat in
    theta_hat_prev's dtype); where R == 0, q = 0 and the hat is unchanged."""
    if isinstance(draw, torch.Generator):
        draw = torch.rand(theta.shape, generator=draw, device=theta.device)
    radius = torch.as_tensor(radius, dtype=torch.float32,
                             device=theta.device).reshape(())
    levels = levels_of(torch.as_tensor(bits, device=theta.device)).reshape(())
    if torch.float64 in (theta.dtype, theta_hat_prev.dtype):
        require_f32(theta, theta_hat_prev)
    q, hat = q_ops.quantize_dequantize(
        theta.reshape(-1), theta_hat_prev.reshape(-1), draw.reshape(-1),
        radius, levels)
    return q.view(theta.shape), hat.view(theta.shape)


def dequantize_tensor(q: Tensor, theta_hat_prev: Tensor, *, radius: Tensor,
                      bits: Tensor) -> Tensor:
    """Receiver-side reconstruction (eq. 13): the sender's float32
    operations, so the result equals its hat bitwise."""
    radius = torch.as_tensor(radius, dtype=torch.float32,
                             device=theta_hat_prev.device)
    levels = levels_of(torch.as_tensor(bits, device=theta_hat_prev.device))
    return q_ops.decode_ref(theta_hat_prev, q, radius, levels)


def global_radius(theta, theta_hat_prev) -> Tensor:
    """R^k = ||theta - theta_hat_prev||_inf over the whole tree (f32)."""
    a = leaves_with_path(theta)
    b = dict(leaves_with_path(theta_hat_prev))
    dev = a[0][1].device if a else None
    parts = [torch.amax(torch.abs(x.to(torch.float32)
                                  - b[p].to(torch.float32)))
             if x.numel() else torch.zeros((), device=dev)
             for p, x in a]
    return (torch.amax(torch.stack(parts)) if parts
            else torch.zeros((), dtype=torch.float32))


def _unflatten(paths, values) -> Any:
    """Leaves in leaf order -> the tree (a lone tensor stays a tensor)."""
    if paths == [()]:
        return values[0]
    out: dict = {}
    for path, v in zip(paths, values):
        _set(out, path, v)
    return out


def quantize(theta, state: QuantState, draws, cfg: QuantizerConfig):
    """Quantize a tree with one shared radius (paper-faithful).

    draws: a ``torch.Generator`` (one draw per leaf, in leaf order) or a
    sequence of per-leaf uniform draws.  Returns (payload, new_state) with
    payload = {'q': tree of uint8, 'radius': f32, 'bits': int32}; its wire
    size is ``payload_bits(cfg, d)``.  The sender's new hat equals the
    receiver's ``dequantize`` bitwise."""
    r_new = global_radius(theta, state.theta_hat)
    bits = _next_bits(cfg, state.bits, r_new, state.radius)
    leaves = leaves_with_path(theta)
    hats = dict(leaves_with_path(state.theta_hat))
    if not isinstance(draws, torch.Generator):
        draws = list(draws)
        if len(draws) != len(leaves):
            raise ValueError(f"{len(draws)} draws for {len(leaves)} leaves")
    qs, new_hats = [], []
    for i, (path, x) in enumerate(leaves):
        d = draws if isinstance(draws, torch.Generator) else draws[i]
        q, hat = quantize_tensor(x, hats[path], d, radius=r_new, bits=bits)
        qs.append(q)
        new_hats.append(hat)
    paths = [p for p, _ in leaves]
    payload = {"q": _unflatten(paths, qs), "radius": r_new, "bits": bits}
    return payload, QuantState(theta_hat=_unflatten(paths, new_hats),
                               radius=r_new, bits=bits)


def dequantize(payload: dict, theta_hat_prev) -> Any:
    """Receiver-side reconstruction of the sender's theta_hat^k."""
    qs = dict(leaves_with_path(payload["q"]))
    leaves = leaves_with_path(theta_hat_prev)
    return _unflatten([p for p, _ in leaves], [
        dequantize_tensor(qs[p], h, radius=payload["radius"],
                          bits=payload["bits"]) for p, h in leaves])


def payload_bits(cfg_or_bits, num_params: int, *, adapt_bits: bool = False,
                 num_radii: int = 1) -> int:
    """Wire size in bits of one transmission: b*d + header."""
    if isinstance(cfg_or_bits, QuantizerConfig):
        b = cfg_or_bits.bits
        adapt_bits = cfg_or_bits.adapt_bits
    else:
        b = int(cfg_or_bits)
    return b * num_params + header_bits(adapt_bits, num_radii)


def header_bits(adapt_bits: bool = True, num_radii: int = 1) -> int:
    """Per-transmission header: one f32 radius per radius scalar plus the
    i32 bit width, which the payload always carries (``adapt_bits`` does
    not change the result; it is kept for call-site compatibility)."""
    del adapt_bits
    return 32 * int(num_radii) + 32
