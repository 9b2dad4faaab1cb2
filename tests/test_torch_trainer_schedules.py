"""The port's trainer schedules and loss options against the jitted JAX
step, on whisper-tiny-smoke, W = 4 on a chain at 4 bits, 3 steps from the
same state, batches and draws (the harness and its tolerances:
``test_torch_trainer.compare_with_jax``).

Cases: ``mode='jacobi'`` (one phase over all workers with the first draw;
wire bits billed for one phase), ``overlap=True`` (the tails compute against
the previous neighbor hats, then both payloads are applied), ``microbatches
= 2`` (each worker's batch of 2 in two chunks, the losses summed in order
and halved) and ``quantize=False`` (full-precision GADMM: the f32 row is the
payload, 32 bits per parameter on every link, no header).  Exact: widths,
``bits_mean``, ``skip_rate``, wire bits; state positions beyond atol 1e-5 at
most ``test_torch_trainer_modes.FRACS``, or FP_FRACS without quantization:
there a neighbor's theta reaches the hats unrounded, so the few positions
where Adam's first steps turn an ulp of gradient at |g| ~ 0 into up to lr
spread to the neighbors (seen 6.8e-5 / 8.2e-5 / 3.5e-4 after steps
0 / 1 / 2).
"""
import pytest

from test_torch_trainer import compare_with_jax, configs
from test_torch_trainer_modes import FRACS

D = 182_400        # whisper-tiny-smoke's parameters per worker
FP_FRACS = (1e-4, 2e-4, 5e-4)
CASES = {
    "jacobi": (dict(mode="jacobi"), 1 * 2 * 3 * (8 * 91_264 + 64)),
    "overlap": (dict(overlap=True), 2 * 2 * 3 * (8 * 91_264 + 64)),
    "microbatches": (dict(microbatches=2), 2 * 2 * 3 * (8 * 91_264 + 64)),
    "full_precision": (dict(quantize=False), 2 * 2 * 3 * 8 * 4 * D),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_matches_jax(case):
    kw, wire_bits = CASES[case]
    jd, td = configs(**kw)
    assert td.pack_wire == (case != "full_precision")
    ms = compare_with_jax(jd, td,
                          FP_FRACS if case == "full_precision" else FRACS)
    assert [float(m["wire_bits_per_round"]) for m in ms] == [wire_bits] * 3
    assert [float(m["skip_rate"]) for m in ms] == [0.0] * 3
