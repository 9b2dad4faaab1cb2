"""The port's bounded-staleness pipeline and partial participation against
the jitted JAX step on whisper-tiny-smoke, W = 4 at 4 bits (packed wire), 3
steps from the same state, batches, draws and participation masks (the
harness: ``test_torch_trainer.compare_with_jax``, which also holds the
port's ring, packed, against the JAX ring and ``hat_lag`` against JAX's).

Cases: staleness 1 on the chain and 2 on the ring (recv-done decodes the
oldest ring entry into ``hat_edge`` and ``hat_lag``, the duals pair
``hat_lag[dst]`` with ``hat_edge`` from step S on, wire bits billed at
send); participation 0.5 on the ring, alone and with staleness 1 (the JAX
step's own Bernoulli mask ``fold_in(key, 0x9A77)``, passed to the port;
absent workers neither compute nor send, neighbor terms reweighted by
deg / #present, duals gated on both endpoints; wire bits from the sent
masks, flags included).  Exact: widths, sent masks, ``skip_rate``, wire bits
(rtol 1e-6 on the dynamic branch, a float32 sum); state positions beyond
atol 1e-5 at most ``test_torch_trainer_modes.FRACS``; ``bit_sync`` (under
staleness against ``hat_lag``) after every step.
"""
import pytest

from test_torch_trainer import compare_with_jax, configs, one_thread
from test_torch_trainer_modes import FRACS

W, D = 4, 182_400
ROW = 8 * 91_264 + 64          # a packed 4-bit row and its header, bits
CASES = {
    "stale1_chain": dict(staleness=1),
    "stale2_ring": dict(staleness=2, topology="ring"),
    "part_ring": dict(participation=0.5, topology="ring"),
    "part_stale1_ring": dict(participation=0.5, staleness=1,
                             topology="ring"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_matches_jax(case):
    kw = CASES[case]
    jd, td = configs(**kw)
    ms = compare_with_jax(jd, td, FRACS,
                          wire_rtol=1e-6 if "part" in case else 0.0)
    edges = 4 if kw.get("topology") == "ring" else 3
    deg = 2 if kw.get("topology") == "ring" else None
    for m in ms:
        sent = m["worker_sent"]
        if "part" in case:
            # every present worker sends once; a flag per directed edge and
            # phase, a row per sending worker's edges
            assert float(m["participants"]) == float(sent.sum())
            assert float(m["wire_bits_per_round"]) == \
                2 * 2 * edges + ROW * deg * float(sent.sum())
        else:
            assert float(m["wire_bits_per_round"]) == 2 * 2 * edges * ROW
    if "part" in case:
        present = [float(m["participants"]) for m in ms]
        assert min(present) < W and max(present) > 0, present


def _run_port(steps=2, part=None, telemetry=True, **kw):
    """The port alone on whisper-tiny-smoke (CPU), its own draws."""
    import dataclasses

    import torch

    from repro_torch.configs import whisper_tiny
    from repro_torch.data.pipeline import ExtraInputs, LMShardLoader
    from repro_torch.dist import qgadmm as tq
    from repro_torch.models import encdec
    td = dataclasses.replace(configs(**kw)[1], telemetry=telemetry)
    cfg = whisper_tiny.smoke_config()
    tr = tq.QGADMMTrainer(encdec, cfg, td, device="cpu")
    st = tq.init_state(lambda g: encdec.init(g, cfg), 0, td, device="cpu")
    loader = LMShardLoader(W, 2, 16, cfg.vocab)
    frames = ExtraInputs.frames(W, 2, cfg.encoder_frames, cfg.d_model)
    with one_thread():
        for _ in range(steps):
            st, m = tr.step(st, dict(loader.next_batch(), frames=frames),
                            part=part)
    return st, m, torch


def test_full_participation_and_telemetry_leave_the_state_unchanged():
    """participation < 1 with every worker present, and telemetry off, give
    the default run's state bitwise (the weights are exactly 1, the
    participation draw has its own generator, telemetry only reads); the
    participation generator is seeded apart from the rounding one."""
    ref, m_ref, torch = _run_port()
    assert "dual_resid" in m_ref
    quiet, m_quiet, _ = _run_port(telemetry=False)
    full, m_full, _ = _run_port(participation=0.5,
                                part=torch.ones(W, dtype=torch.bool))
    assert "dual_resid" not in m_quiet
    assert float(m_full["participants"]) == W
    bits_of = lambda t: t.view(torch.int32) if t.is_floating_point() else t
    for f in ("theta", "theta_hat", "hat_edge", "lam_edge", "radius", "bits",
              "opt_mu", "opt_nu"):
        for other in (quiet, full):
            assert torch.equal(bits_of(getattr(ref, f)),
                               bits_of(getattr(other, f))), f
    assert ref.part_gen.initial_seed() != ref.gen.initial_seed()
