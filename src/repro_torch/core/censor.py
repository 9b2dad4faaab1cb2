"""Censored transmissions (CQ-GGADMM, Ben Issaid et al. 2020).

Worker n transmits its new quantized model only when it moved far enough
from the value its neighbors hold,

    || theta_hat_n^{k+1} - theta_hat_n^{last sent} ||_2  >  tau * xi^k ,

and otherwise sends a 1-bit flag; the sender rolls its own hat / radius /
bits back too, so both ends of every edge stay bitwise equal.  Counterpart
of ``repro/core/censor.py``.

The hats are given as sequences of (W, ...) leaves in the JAX leaf order
(the trainer passes ``layout.split(flat)``): the squared
distance is summed per leaf, then over the leaves in order, in float32, as
the reference sums it.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

Tensor = torch.Tensor

#: Bits a censored (skipped) directed transmission still costs on the wire:
#: the censor flag itself, per link, direction and phase.
FLAG_BITS = 1


@dataclasses.dataclass(frozen=True)
class CensorConfig:
    """Decaying censoring threshold tau * xi^k (tau > 0, 0 < xi < 1)."""

    tau: float = 0.05
    xi: float = 0.9

    def __post_init__(self):
        assert self.tau > 0, f"tau must be positive, got {self.tau}"
        assert 0.0 < self.xi < 1.0, f"xi must be in (0, 1), got {self.xi}"


def threshold(cfg: CensorConfig, step, device=None) -> Tensor:
    """tau * xi^k as a float32 scalar on `device`."""
    k = torch.as_tensor(step, dtype=torch.float32, device=device)
    xi = torch.tensor(cfg.xi, dtype=torch.float32, device=k.device)
    return cfg.tau * torch.pow(xi, k)


def per_leaf_sq(a_leaves: Sequence[Tensor], b_leaves: Sequence[Tensor]
                ) -> Tensor:
    """(W, L) squared L2 distance of each pair of (W, ...) leaves, in
    float32 (zero-size leaves give 0)."""
    cols = []
    for a, b in zip(a_leaves, b_leaves):
        d = (a.to(torch.float32) - b.to(torch.float32)).reshape(a.shape[0], -1)
        cols.append(torch.sum(d * d, dim=1))
    return torch.stack(cols, dim=1)


def delta_sq(hat_new: Sequence[Tensor], hat_prev: Sequence[Tensor]) -> Tensor:
    """(W,) squared L2 distance between two stacked hats: per-leaf sums,
    added over the non-empty leaves in leaf order."""
    parts = per_leaf_sq(hat_new, hat_prev)
    total = None
    for i, a in enumerate(hat_new):
        if a[0].numel():
            total = parts[:, i] if total is None else total + parts[:, i]
    return torch.zeros_like(parts[:, 0]) if total is None else total


def transmit_mask(hat_new: Sequence[Tensor], hat_prev: Sequence[Tensor],
                  cfg: CensorConfig, step) -> Tensor:
    """(W,) bool: True = transmit (moved past the threshold), False =
    censor (send only the flag; everyone keeps hat_prev)."""
    thr = threshold(cfg, step, device=hat_new[0].device)
    return delta_sq(hat_new, hat_prev) > thr * thr
