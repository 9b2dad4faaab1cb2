"""The port's trainer on the two-tier graph and with telemetry against the
jitted JAX step on whisper-tiny-smoke at 4 bits, 3 steps from the same
state, batches and draws (the harness:
``test_torch_trainer.compare_with_jax``; state positions beyond atol 1e-5 at
most ``test_torch_trainer_modes.FRACS``).

Cases:
- ``cluster_of_stars`` at W 3, the smallest worker count with two clusters
  (edges 0-1 and the backbone 0-2);
- telemetry on both sides (W 4, chain), with censoring that silences
  workers in steps 1 and 2, and under layerwise (per-leaf widths and
  periods): the payload / header / flag split of the wire bits, tx and
  skip links, participants, the per-worker sent mask and the per-leaf mean
  widths, exact (the split rtol 1e-6, a float32 sum); the dual residual
  rtol 1e-4.
"""
import pytest

from test_torch_trainer import compare_with_jax, configs
from test_torch_trainer_modes import FRACS


def test_cluster_of_stars_matches_jax():
    jd, td = configs(topology="cluster_of_stars", num_workers=3)
    compare_with_jax(jd, td, FRACS)


@pytest.mark.parametrize("case", ["censor", "layerwise"])
def test_telemetry_matches_jax(case):
    if case == "censor":
        jd, td = configs(telemetry=True, censor={"tau": 14.0, "xi": 0.9})
    else:
        jd, td = configs(telemetry=True, layerwise=dict(
            bits=tuple(2 if i % 2 else 4 for i in range(25)),
            periods=tuple(2 if i % 3 == 2 else 1 for i in range(25))))
    ms = compare_with_jax(jd, td, FRACS, wire_rtol=1e-6)
    if case == "censor":
        assert [float(m["skip_rate"]) for m in ms] == [0.0, 0.5, 0.5]
        assert [float(m["skip_links"]) for m in ms] == [0.0, 3.0, 3.0]
    else:
        assert all(m["leaf_bits"].shape == (25,) for m in ms)
