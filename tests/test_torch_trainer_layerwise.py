"""The port's layerwise (L-FGADMM) trainer against the jitted JAX step, on
whisper-tiny-smoke (25 leaves), W = 4 on a chain, 3 steps from the same
state, batches and draws (the harness and its tolerances:
``test_torch_trainer.compare_with_jax``).

Cases: per-leaf base widths (4 and 2 bits alternating, so the codec gets
per-element levels and the wire stays packed), every third leaf on period 2
(off in step 1) and per-leaf thresholds 1.0 * 0.9^k; and the bit-budget
controller at 4 bits per parameter (widths 1 to 8, unpacked wire).  Exact:
the (W, L) bits tables, ``bits_mean``, ``skip_rate``; wire bits rtol 1e-6 (a
float32 sum); state positions beyond atol 1e-5 bounded as in
``test_torch_trainer_modes`` (observed at most 1e-5).
"""
import pytest
import torch

from test_torch_trainer import compare_with_jax, configs
from test_torch_trainer_modes import FRACS

L = 25
CASES = {
    "leaf_tables": dict(
        bits=tuple(2 if i % 2 else 4 for i in range(L)),
        periods=tuple(2 if i % 3 == 2 else 1 for i in range(L)),
        taus=1.0, tau_xi=0.9),
    "budget": dict(budget_bits=4 * 182_400),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layerwise_matches_jax(case):
    jd, td = configs(layerwise=CASES[case])
    assert td.radius_mode == jd.radius_mode == "per_tensor"
    assert td.pack_wire == (case == "leaf_tables")
    ms = compare_with_jax(jd, td, FRACS, wire_rtol=1e-6)
    widths = [m["leaf_bits_sent"] for m in ms]
    sent = [b > 0 for b in widths]
    assert all(s.shape == (4, L) for s in sent)
    if case == "leaf_tables":
        gated = torch.tensor([i % 3 == 2 for i in range(L)])
        assert sent[0][:, gated].any() and not sent[1][:, gated].any()
        assert not all(bool(s.all()) for s in sent)   # taus censor leaves
    else:
        used = torch.cat([b[s] for b, s in zip(widths, sent)])
        assert int(used.min()) == 1 and int(used.max()) == 8
