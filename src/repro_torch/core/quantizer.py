"""Stochastic quantizer of Q-GADMM (paper eqs. 6-13): configuration and
payload accounting.

Worker n quantizes the difference between its model and its previous hat:

    R      = ||theta - theta_hat_prev||_inf
    Delta  = 2 R / (2^b - 1)
    q_i    = stochastic rounding of (theta_i - theta_hat_prev_i + R) / Delta
    theta_hat = theta_hat_prev + Delta * q - R

The arithmetic itself is the codec kernel (``repro_torch.kernels.quantize``).
Counterpart of ``repro/core/quantizer.py``; only ``QuantizerConfig`` and
``header_bits`` are ported so far (the eq. 11 bit-growth rule, the per-tensor
functions and the layerwise allocator wait).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QuantizerConfig:
    """bits: quantizer resolution b (levels = 2^b - 1 intervals).
    adapt_bits: the eq. 11 bit-growth rule (not ported yet; must stay off).
    max_bits: cap for adaptive bits."""

    bits: int = 2
    adapt_bits: bool = False
    max_bits: int = 8

    def __post_init__(self):
        assert 1 <= self.bits <= self.max_bits <= 8


def header_bits(adapt_bits: bool = True, num_radii: int = 1) -> int:
    """Per-transmission header: one f32 radius per radius scalar plus the
    i32 bit width, which the payload always carries (``adapt_bits`` does
    not change the result; it is kept for call-site compatibility)."""
    del adapt_bits
    return 32 * int(num_radii) + 32
