"""The port's trainer in its adaptive quantizer modes against the jitted JAX
step, on whisper-tiny-smoke, W = 4 on a chain, 3 steps from the same state,
batches and draws (the harness and its tolerances:
``test_torch_trainer.compare_with_jax``).

Cases: ``radius_mode='per_tensor'`` at 4 bits (the codec's per-element
radius variant, packed wire), per_tensor with eq. 11 capped at 4 bits,
global with eq. 11 up to 8 bits (unpacked), and censoring with a tau that
censors the tails in step 1 and the heads in step 2 (the per-worker L2
deltas sit 0.5% or more from the threshold, far beyond float noise).

Exact: bits tables, ``bits_mean``, ``skip_rate``; wire bits exact on the
static branch and rtol 1e-6 on the censored one (a float32 sum).  State
positions beyond atol 1e-5: at most FRACS[k] after step k.  Over three
steps Adam's first updates (lr * g / (|g| + eps)) turn ulp differences at
|g| ~ 0 into up to lr, and a few levels then move by one: at most 4e-5 of
the positions (per_tensor, step 2; 2 of 729,600 theta positions already in
step 0), each within the hat bound of the harness.
"""
import pytest

from test_torch_trainer import compare_with_jax, configs

CASES = {
    "per_tensor": dict(radius_mode="per_tensor"),
    "per_tensor_eq11": dict(
        radius_mode="per_tensor",
        qcfg={"bits": 4, "adapt_bits": True, "max_bits": 4}),
    "global_eq11_8bit": dict(
        qcfg={"bits": 8, "adapt_bits": True, "max_bits": 8}),
    "censor": dict(censor={"tau": 14.0, "xi": 0.9}),
}
FRACS = (1e-5, 2e-5, 1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mode_matches_jax(case):
    jd, td = configs(**CASES[case])
    assert td.pack_wire == (case != "global_eq11_8bit")
    wire_rtol = 1e-6 if td.censor is not None else 0.0
    ms = compare_with_jax(jd, td, FRACS, wire_rtol=wire_rtol)
    skip = [float(m["skip_rate"]) for m in ms]
    assert skip == ([0.0, 0.5, 0.5] if case == "censor" else [0.0] * 3)
    bits = [float(m["bits_mean"]) for m in ms]
    assert (len(set(bits)) > 1) == ("eq11" in case), bits
