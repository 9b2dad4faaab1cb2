"""Opt-in live invariants (``REPRO_CHECK=1`` or DistConfig.check_invariants).

The port's copy of the trainer half of ``repro/obs/checks.py``, reading the
port's flat state:

  * ``check_step_window`` — every step's billed ``wire_bits_per_round`` must
    equal payload + header + flags, and the non-layerwise components must
    match the closed form from the wire row (8 * wire_row_bytes + quantizer
    sideband per transmitted directed link, censor.FLAG_BITS per flag).
  * ``check_edge_mirrors`` — edge-state conservation: the two directed rows
    of every undirected edge hold the same canonical head->tail dual.

Both raise ``ObsCheckError`` with the offending numbers.  The simulator's
checks (``check_timeline`` / ``check_trace``) come with the port of
``sim/`` and ``obs/``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.core import censor as censor_mod
from repro_torch.core.quantizer import header_bits

ENV_FLAG = "REPRO_CHECK"


class ObsCheckError(AssertionError):
    pass


def enabled(dcfg=None) -> bool:
    if os.environ.get(ENV_FLAG, "") == "1":
        return True
    return bool(dcfg is not None
                and getattr(dcfg, "check_invariants", False))


def _close(name: str, got: float, want: float, rtol: float = 1e-6) -> None:
    if not np.isclose(got, want, rtol=rtol, atol=1e-6):
        raise ObsCheckError(f"repro.obs check failed: {name}: "
                            f"got {got!r}, want {want!r}")


def check_step_window(trainer, state, records) -> None:
    """Cross-check a window of host-side step records (``{"step": k,
    "metrics": {name: float}}``) against the wire format's closed form."""
    dcfg = trainer.dcfg
    n_edges = trainer.topo.num_edges
    if n_edges == 0 or not records:
        return
    sizes = state.layout.sizes
    row_bits = 8 * trainer.wire_row_bytes(state.layout.size)
    n_r = len(sizes) if dcfg.radius_mode == "per_tensor" else 1
    sideband = header_bits(num_radii=n_r) if dcfg.gadmm.quantize else 0
    n_phases = 2 if dcfg.mode == "gauss-seidel" else 1
    dynamic = dcfg.censor is not None or dcfg.participation < 1.0
    for rec in records:
        m = rec["metrics"]
        need = ("wire_bits_per_round", "wire_bits_payload",
                "wire_bits_header", "wire_bits_flags")
        if any(k not in m for k in need):
            raise ObsCheckError("repro.obs check needs telemetry metrics "
                                f"{need}; enable DistConfig.telemetry")
        total = m["wire_bits_per_round"]
        payload, header, flags = (m["wire_bits_payload"],
                                  m["wire_bits_header"],
                                  m["wire_bits_flags"])
        _close(f"step {rec['step']}: payload+header+flags == total",
               payload + header + flags, total)
        if dcfg.layerwise is not None:
            _close(f"step {rec['step']}: layerwise flag bits",
                   flags,
                   n_phases * 2 * n_edges * len(sizes) * censor_mod.FLAG_BITS)
            continue
        links = m["tx_links"] if dynamic else n_phases * 2 * n_edges
        _close(f"step {rec['step']}: payload == row_bits * links",
               payload, row_bits * links)
        _close(f"step {rec['step']}: header == sideband * links",
               header, sideband * links)
        _close(f"step {rec['step']}: flag bits",
               flags,
               n_phases * 2 * n_edges * censor_mod.FLAG_BITS
               if dynamic else 0.0)


def check_edge_mirrors(trainer, state) -> None:
    """Edge-state conservation: the two directed rows of every edge hold the
    same canonical head->tail dual.  One endpoint computes the increment
    from its own hat and the other from the decoded wire copy, so the
    mirrors agree to float rounding: per leaf the tolerance is 1e-3 of the
    dual's largest magnitude, far below the O(increment) divergence a
    desync produces.  Computed on the state's device in float32 (the
    difference of two float32 values is off by at most one ulp of the
    larger, far inside the tolerance)."""
    eidx = trainer.eidx
    if not eidx.num_directed:
        return
    row = {(int(s), int(t)): i
           for i, (s, t) in enumerate(zip(eidx.src, eidx.dst))}
    rev = torch.as_tensor([row[(int(t), int(s))]
                           for s, t in zip(eidx.src, eidx.dst)],
                          device=state.lam_edge.device)
    for i, a in enumerate(state.layout.split(state.lam_edge)):
        if a.shape[1] == 0:                   # empty leaves carry no dual
            continue
        tol = 1e-3 * float(torch.amax(torch.abs(a))) + 1e-8
        diff = torch.amax(torch.abs(a[rev] - a), dim=1).cpu().numpy()
        if np.any(diff > tol):
            bad = np.flatnonzero(diff > tol)
            raise ObsCheckError(
                f"repro.obs check failed: lam_edge mirror broken on leaf "
                f"{i}, directed rows {bad[:8].tolist()} (of "
                f"{eidx.num_directed}), max diff {diff.max():.3e} > "
                f"{tol:.3e}")
