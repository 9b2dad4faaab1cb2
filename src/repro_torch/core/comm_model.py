"""Wireless communication cost model of paper Sec. V-A.

The port's own copy of ``repro/core/comm_model.py`` (numpy only, the same
arithmetic), for the energy columns of the paper's Fig. 2.

Free-space pathloss, Shannon capacity: to ship `bits` within slot time tau over
bandwidth B at distance D with noise PSD N0, the required rate is
R = bits / tau [bit/s], the required transmit power is

    P = D^2 * N0 * B * (2^(R/B) - 1)        (Shannon, free-space D^2 loss)

and the consumed energy is E = P * tau.  Paper defaults: total system bandwidth
2 MHz split across concurrently-transmitting workers; N0 = 1e-6 W/Hz; tau = 1 ms
(100 ms for the DNN task).

Bandwidth split: GADMM-family alternates head/tail groups so only half the
workers transmit per communication round -> each gets (2*Btot/N); PS-based
algorithms have all N workers competing -> Btot/N.

Beyond the paper's chain, ``round_energy_topology`` prices a round on any
bipartite topology (core.topology) — per-phase bandwidth sharing within the
transmitting head/tail group, per-worker broadcast distance from the
topology-dispatched ``topology.Placement.broadcast_dist`` — and supports CQ-GGADMM
censoring: skipped workers transmit only the 1-bit censor flag.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RadioConfig:
    total_bandwidth_hz: float = 2e6
    noise_psd: float = 1e-6         # W/Hz
    slot_s: float = 1e-3            # tau
    n_workers: int = 50

    def worker_bandwidth(self, decentralized: bool) -> float:
        share = 2.0 if decentralized else 1.0
        return share * self.total_bandwidth_hz / self.n_workers


def tx_energy(bits: float, dist_m: float, bandwidth_hz: float,
              slot_s: float, noise_psd: float) -> float:
    """Energy (J) to transmit `bits` in one slot at distance dist_m."""
    rate = bits / slot_s
    power = (dist_m**2) * noise_psd * bandwidth_hz * (2.0 ** (rate / bandwidth_hz) - 1.0)
    return power * slot_s


def round_energy_decentralized(bits_per_worker: np.ndarray, dists: np.ndarray,
                               radio: RadioConfig) -> float:
    """Sum energy of one GADMM/Q-GADMM communication round (all N broadcasts)."""
    bw = radio.worker_bandwidth(decentralized=True)
    return float(
        sum(tx_energy(b, d, bw, radio.slot_s, radio.noise_psd)
            for b, d in zip(np.broadcast_to(bits_per_worker, dists.shape), dists))
    )


def round_energy_ps(upload_bits: float, ps_dists: np.ndarray,
                    download_bits: float, radio: RadioConfig) -> float:
    """N uplinks of upload_bits + one PS downlink of download_bits (to the
    farthest worker, full band)."""
    bw = radio.worker_bandwidth(decentralized=False)
    up = sum(tx_energy(upload_bits, d, bw, radio.slot_s, radio.noise_psd)
             for d in ps_dists)
    down = tx_energy(download_bits, float(ps_dists.max()),
                     radio.total_bandwidth_hz, radio.slot_s, radio.noise_psd)
    return float(up + down)


def round_energy_topology(placement, bits_per_worker, radio: RadioConfig,
                          sent=None, flag_bits: int | None = None) -> float:
    """Energy of one GGADMM round on an arbitrary bipartite topology,
    optionally with censored transmissions (CQ-GGADMM).

    The round has two phases — heads broadcast, then tails broadcast — and
    only the transmitting group shares the band, so each transmitter in a
    group of size G gets total_bandwidth / G (the chain's 50/50 head/tail
    split reduces to the paper's 2*Btot/N rule).  Every worker broadcasts
    once per round at the power its FARTHEST neighbor requires
    (placement.broadcast_dist, topology-dispatched: the star hub must reach
    its farthest leaf).

    With censoring, ``sent`` is an (N,) bool mask of the workers that
    cleared the threshold this round; the others transmit only the
    ``flag_bits`` censor flag (default core.censor.FLAG_BITS).
    """
    topo = placement.resolved_topology()
    bd = placement.broadcast_dist()
    bits = np.broadcast_to(np.asarray(bits_per_worker, float), (topo.n,))
    if sent is not None:
        if flag_bits is None:
            from .censor import FLAG_BITS as flag_bits
        bits = np.where(np.asarray(sent, bool), bits, float(flag_bits))
    heads = np.flatnonzero(topo.head_mask)
    tails = np.flatnonzero(~topo.head_mask)
    total = 0.0
    for group in (heads, tails):
        if not len(group):
            continue
        bw = radio.total_bandwidth_hz / len(group)
        total += sum(tx_energy(bits[i], bd[i], bw, radio.slot_s,
                               radio.noise_psd) for i in group)
    return float(total)
