"""GADMM / Q-GADMM configuration (paper Algorithm 1).

Counterpart of ``repro/core/gadmm.py``; only ``GADMMConfig`` is ported so
far.  The chain and graph reference solvers come in a later slice.
"""
from __future__ import annotations

import dataclasses

from .quantizer import QuantizerConfig


@dataclasses.dataclass(frozen=True)
class GADMMConfig:
    """rho: augmented-Lagrangian penalty; quantize: send quantized hats (Q-GADMM)
    or full precision (GADMM); qcfg: the quantizer; alpha: dual damping (the
    paper uses 1 for convex problems, 0.01 for DNNs); topk_frac: fraction of
    coordinates sent per round (1.0 = dense)."""

    rho: float = 24.0
    quantize: bool = True
    qcfg: QuantizerConfig = QuantizerConfig(bits=2)
    alpha: float = 1.0
    topk_frac: float = 1.0
