"""The port's trainer against ``repro.dist.qgadmm.QGADMMTrainer.make_train_step``
on whisper-tiny-smoke, W = 4 workers on a chain.

Both sides start from the same state (the JAX ``init_state``, carried across
by ``repro_torch.convert``), see the same batches and consume the JAX step's
own uniform draws (per step ``key, k1, k2 = split(state.key, 3)``, then one
(W, D) draw per phase, as at ``qgadmm.py:1241`` and ``:860``).  Two steps each
at 4 bits (the nibble-packed wire: pack4 -> gather -> unpack4) and 8 bits
(unpacked).

Tolerances: ``loss`` and ``consensus_resid`` rtol 1e-4 (f32 sums in another
order); ``wire_bits_per_round`` exact; theta, Adam moments, duals and hats
atol 1e-5 except at a small fraction of positions where a float difference
crossed a rounding edge — a level moves by one, so the hat moves by at most
the theta difference plus one quantization step — and where Adam's first
steps (update ~ lr * g / |g|) turn a tiny difference at |g| ~ 0 into up to
2 * lr.  At 4 bits no position
differs (fraction 0 required).  At 8 bits the reference computes the codec
step as 2R * (1/255) — XLA folds the constant levels into a reciprocal —
where the port divides, so hats differ by a few ulp everywhere; in step 0
fewer than 1e-4 of the positions cross an edge, and in step 1, where R has
shrunk ~100x and the 8-bit grid is that much finer, fewer than 5e-3.

Inside the port, ``hat_edge[d]`` must be bitwise ``theta_hat[src[d]]`` after
every step: sender == receiver.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import whisper_tiny as j_whisper
from repro.core.gadmm import GADMMConfig as JGADMMConfig
from repro.core.quantizer import QuantizerConfig as JQuantizerConfig
from repro.data.pipeline import ExtraInputs, LMShardLoader
from repro.dist import qgadmm as jq
from repro.models import encdec as j_encdec
from repro_torch.configs import whisper_tiny as t_whisper
from repro_torch.convert import state_from_jax
from repro_torch.core.gadmm import GADMMConfig
from repro_torch.core.quantizer import QuantizerConfig
from repro_torch.dist import qgadmm as tq
from repro_torch.models import encdec as t_encdec

W = 4
# (bits, per-step max fraction of positions beyond atol)
CASES = {4: (0.0, 0.0), 8: (1e-4, 5e-3)}


def _configs(bits):
    jd = jq.DistConfig(num_workers=W, gadmm=JGADMMConfig(
        rho=1.0, quantize=True, qcfg=JQuantizerConfig(bits=bits), alpha=0.01),
        telemetry=False)
    td = tq.DistConfig(num_workers=W, gadmm=GADMMConfig(
        rho=1.0, quantize=True, qcfg=QuantizerConfig(bits=bits), alpha=0.01))
    return jd, td


def _frac_beyond(a, b, atol):
    return float(((a - b).abs() > atol).float().mean())


@pytest.mark.parametrize("bits", sorted(CASES))
def test_trainer_matches_jax(bits):
    jcfg = j_whisper.smoke_config(remat=False)
    tcfg = t_whisper.smoke_config()
    jd, td = _configs(bits)
    assert td.pack_wire == jd.pack_wire == (bits <= 4)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("worker", "fsdp", "model"))
    jtr = jq.QGADMMTrainer(j_encdec, jcfg, jd, mesh)
    jst = jq.init_state(lambda k: j_encdec.init(k, jcfg),
                        jax.random.PRNGKey(0), jd)
    jstep = jax.jit(jtr.make_train_step())
    ttr = tq.QGADMMTrainer(t_encdec, tcfg, td, device="cpu")
    tst = state_from_jax(jax.tree.map(np.asarray, jst), "cpu")
    d = tst.layout.size
    loader = LMShardLoader(W, 2, 16, jcfg.vocab)
    frames = ExtraInputs.frames(W, 2, jcfg.encoder_frames, jcfg.d_model)
    levels = 2.0 ** bits - 1.0
    for k, frac in enumerate(CASES[bits]):
        batch = loader.next_batch()
        batch["frames"] = frames
        _, k1, k2 = jax.random.split(jst.key, 3)
        u = [np.array(jax.random.uniform(kk, (W, d), jnp.float32))
             for kk in (k1, k2)]
        jst, jm = jstep(jst, batch)
        tst, tm = ttr.step(tst, batch, u=u)
        for name in ("loss", "consensus_resid", "radius_mean"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-4, err_msg=name)
        for name in ("bits_mean", "skip_rate", "wire_bits_per_round"):
            assert float(tm[name]) == float(jm[name]), name
        ref = state_from_jax(jax.tree.map(np.asarray, jst), "cpu")
        assert torch.equal(tst.opt_t, ref.opt_t) and tst.step == ref.step
        assert torch.equal(tst.bits, ref.bits)
        for f in ("theta", "opt_mu", "opt_nu", "lam_edge", "theta_hat",
                  "hat_edge"):
            got = _frac_beyond(getattr(tst, f), getattr(ref, f), 1e-5)
            assert got <= frac, (k, f, got)
        # the codec moves a hat by at most the theta difference plus one
        # level (one quantization step)
        bound = ((tst.theta - ref.theta).abs()
                 + 1.001 * (2.0 * ref.radius / levels)[:, None] + 1e-6)
        assert bool(((tst.theta_hat - ref.theta_hat).abs() <= bound).all()), k
        assert bool(((tst.hat_edge - ref.hat_edge).abs()
                     <= bound[ttr._src]).all()), k
        assert ttr.bit_sync(tst), k


def test_unported_options_raise():
    g = GADMMConfig(rho=1.0, qcfg=QuantizerConfig(bits=4))
    for kw in ({"censor": object()}, {"staleness": 1},
               {"participation": 0.5}, {"mode": "jacobi"},
               {"radius_mode": "per_tensor"}, {"microbatches": 2},
               {"overlap": True}, {"layerwise": object()},
               {"state_dtype": torch.bfloat16}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tq.DistConfig(num_workers=W, gadmm=g, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tq.DistConfig(num_workers=W, gadmm=GADMMConfig(quantize=False))


def test_cli_smoke_runs_on_cpu(capsys):
    """`python -m repro_torch.launch.train --smoke --device cpu` runs the
    same path at smoke size and prints the JAX launcher's step line."""
    from repro_torch.launch import train
    assert train.main(["--smoke", "--device", "cpu", "--steps", "2",
                       "--workers", "4", "--bits", "4",
                       "--per-worker-batch", "2", "--seq", "16",
                       "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "step 2: loss=" in out and "resid=" in out and "done" in out
