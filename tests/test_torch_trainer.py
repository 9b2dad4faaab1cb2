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

The bit-width tables must be equal and the radius tables agree to rtol
1e-4 (R = max |theta - hat| follows theta's last bits once the Adam moments
have drifted by an ulp; 1.2e-5 seen).

Inside the port, ``hat_edge[d]`` must be bitwise ``theta_hat[src[d]]`` after
every step: sender == receiver (under staleness, ``hat_lag[src[d]]``).

The harness (``compare_with_jax``) also serves the option files
(``test_torch_trainer_{modes,layerwise,schedules,pipeline,dtypes,
telemetry}.py``): it passes the JAX step's participation mask, holds the
port's staleness ring and ``hat_lag`` against JAX's, counts a bf16 leaf's
columns within one bf16 ulp instead of atol 1e-5, and compares the
telemetry metrics when the JAX side has them on.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import whisper_tiny as j_whisper
from repro.core.censor import CensorConfig as JCensorConfig
from repro.core.gadmm import GADMMConfig as JGADMMConfig
from repro.core.quantizer import LayerwiseConfig as JLayerwiseConfig
from repro.core.quantizer import QuantizerConfig as JQuantizerConfig
from repro.data.pipeline import ExtraInputs, LMShardLoader
from repro.dist import qgadmm as jq
from repro.models import encdec as j_encdec
from repro_torch.configs import whisper_tiny as t_whisper
from repro_torch.convert import state_from_jax
from repro_torch.core.censor import CensorConfig
from repro_torch.core.gadmm import GADMMConfig
from repro_torch.core.quantizer import (LayerwiseConfig, QuantizerConfig,
                                        levels_of)
from repro_torch.dist import qgadmm as tq
from repro_torch.models import encdec as t_encdec

W = 4
# (bits, per-step max fraction of positions beyond atol)
CASES = {4: (0.0, 0.0), 8: (1e-4, 5e-3)}
# the metrics telemetry adds; participants and the wire split are exact
TELEMETRY = ("wire_bits_payload", "wire_bits_header", "wire_bits_flags",
             "tx_links", "skip_links", "participants", "dual_resid")


def configs(qcfg=None, censor=None, layerwise=None, quantize=True,
            num_workers=W, telemetry=False, state_dtype=None, **kw):
    """The same trainer configuration for both packages: rho 1, alpha 0.01,
    `qcfg` / `censor` / `layerwise` as keyword dicts of their configs,
    `state_dtype` as a torch dtype (its JAX twin on the JAX side).  The JAX
    side's telemetry is off unless `telemetry`; the port's stays on."""
    qcfg = qcfg or {"bits": 4}
    j_dtype = None if state_dtype is None else jnp.dtype(
        str(state_dtype).removeprefix("torch."))

    def one(dist, gadmm, quant, cens, lw, **extra):
        return dist(
            num_workers=num_workers,
            gadmm=gadmm(rho=1.0, quantize=quantize, qcfg=quant(**qcfg),
                        alpha=0.01),
            censor=None if censor is None else cens(**censor),
            layerwise=None if layerwise is None else lw(**layerwise),
            **kw, **extra)

    return (one(jq.DistConfig, JGADMMConfig, JQuantizerConfig, JCensorConfig,
                JLayerwiseConfig, telemetry=telemetry, state_dtype=j_dtype),
            one(tq.DistConfig, GADMMConfig, QuantizerConfig, CensorConfig,
                LayerwiseConfig, state_dtype=state_dtype))


def _frac_beyond(a, b, atol, layout=None):
    """Fraction of positions where |a - b| > atol; with `layout`, columns
    of a narrower leaf count instead where |a - b| exceeds one ulp of that
    dtype at max(|a|, |b|)."""
    err = (a - b).abs()
    tol = torch.full_like(err, atol)
    for off, n, dt in (layout.narrow if layout is not None else ()):
        mag = torch.maximum(a[..., off:off + n].abs(),
                            b[..., off:off + n].abs())
        tol[..., off:off + n] = _ulp(mag, dt)
    return float((err > tol).float().mean())


def _ulp(mag, dtype):
    """One ulp of `dtype` at magnitude `mag` (its smallest normal's ulp
    below that)."""
    expo = torch.floor(torch.log2(torch.clamp(
        mag, min=torch.finfo(dtype).tiny)))
    return torch.exp2(expo - _MANT[dtype])


_MANT = {torch.bfloat16: 7, torch.float16: 10}   # explicit mantissa bits


def _per_position(t, layout):
    """(W,) -> (W, 1); (W, L) per-leaf table -> (W, D)."""
    return t[:, None] if t.dim() == 1 else t.index_select(
        1, layout.leaf_index())


def _narrow_ulp(t, layout):
    """Per position: one ulp of the leaf's dtype at |t| in a narrower
    leaf's columns, 0 elsewhere."""
    out = torch.zeros_like(t)
    for off, n, dt in layout.narrow:
        out[..., off:off + n] = _ulp(t[..., off:off + n].abs(), dt)
    return out


def jax_part_mask(jd, key):
    """The JAX step's participation draw of the round with state key
    `key` (``participation_masks``), as numpy."""
    return np.asarray(jax.random.bernoulli(
        jax.random.fold_in(key, 0x9A77), jd.participation,
        (jd.num_workers,)))


@contextlib.contextmanager
def one_thread():
    """torch on one intra-op thread, restored after: the suite runs several
    test workers on one machine, and a worker's default pool (a thread per
    core, spinning) oversubscribes the cores several times over — the
    JAX-compiling cases here ran 3-4x slower for it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def compare_with_jax(jd, td, fracs, wire_rtol=0.0, init_cast=None):
    """``_compare_with_jax`` with torch on one thread (``one_thread``)."""
    with one_thread():
        return _compare_with_jax(jd, td, fracs, wire_rtol, init_cast)


def _compare_with_jax(jd, td, fracs, wire_rtol=0.0, init_cast=None):
    """Run the jitted JAX step and the port's step side by side on
    whisper-tiny-smoke for len(fracs) steps from the same state, batches,
    draws and participation masks, and hold them together after every step
    (see the module docstring); fracs[k] bounds the fraction of state
    positions beyond atol 1e-5 (one ulp in the columns of a bf16 leaf)
    after step k.  `init_cast` maps the JAX init tree before the state is
    built (e.g. casting some leaves).  Returns the port's metrics of every
    step."""
    w = jd.num_workers
    jcfg = j_whisper.smoke_config(remat=False)
    tcfg = t_whisper.smoke_config()
    assert td.pack_wire == jd.pack_wire
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("worker", "fsdp", "model"))
    jtr = jq.QGADMMTrainer(j_encdec, jcfg, jd, mesh)
    cast = init_cast or (lambda t: t)
    jst = jq.init_state(lambda k: cast(j_encdec.init(k, jcfg)),
                        jax.random.PRNGKey(0), jd)
    jstep = jax.jit(jtr.make_train_step())
    ttr = tq.QGADMMTrainer(t_encdec, tcfg, td, device="cpu")
    to_port = lambda st: state_from_jax(jax.tree.map(np.asarray, st), "cpu",
                                        pack_wire=td.pack_wire)
    tst = to_port(jst)
    layout = tst.layout
    loader = LMShardLoader(w, 2, 16, jcfg.vocab)
    frames = ExtraInputs.frames(w, 2, jcfg.encoder_frames, jcfg.d_model)
    out = []
    for k, frac in enumerate(fracs):
        batch = loader.next_batch()
        batch["frames"] = frames
        _, k1, k2 = jax.random.split(jst.key, 3)
        u = [np.array(jax.random.uniform(kk, (w, layout.size), jnp.float32))
             for kk in (k1, k2)]
        part = (jax_part_mask(jd, jst.key) if jd.participation < 1.0
                else None)
        jst, jm = jstep(jst, batch)
        tst, tm = ttr.step(tst, batch, u=u, part=part)
        for name in ("loss", "consensus_resid", "radius_mean"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-4, err_msg=name)
        for name in ("bits_mean", "skip_rate"):
            assert float(tm[name]) == float(jm[name]), (k, name)
        np.testing.assert_allclose(float(tm["wire_bits_per_round"]),
                                   float(jm["wire_bits_per_round"]),
                                   rtol=wire_rtol, err_msg="wire bits")
        if jd.telemetry:
            for name in TELEMETRY:
                np.testing.assert_allclose(
                    float(tm[name]), float(jm[name]),
                    rtol=1e-4 if name == "dual_resid" else wire_rtol,
                    err_msg=name)
            np.testing.assert_array_equal(tm["worker_sent"].numpy(),
                                          np.asarray(jm["worker_sent"]))
            if jd.layerwise is not None:
                np.testing.assert_array_equal(tm["leaf_bits"].numpy(),
                                              np.asarray(jm["leaf_bits"]))
        ref = to_port(jst)
        assert torch.equal(tst.opt_t, ref.opt_t) and tst.step == ref.step
        assert torch.equal(tst.bits, ref.bits), k
        # R = max |theta - hat| moves with theta's last bits
        torch.testing.assert_close(tst.radius, ref.radius, rtol=1e-4,
                                   atol=0.0)
        fields = ["theta", "opt_mu", "opt_nu", "lam_edge", "theta_hat",
                  "hat_edge"] + (["hat_lag"] if td.staleness else [])
        for f in fields:
            got = _frac_beyond(getattr(tst, f), getattr(ref, f), 1e-5,
                               layout)
            assert got <= frac, (k, f, got)
        # the codec moves a hat by at most the theta difference plus one
        # level (one quantization step at the committed radius and width),
        # plus one ulp where the hat is rounded to a narrower leaf dtype
        grid = (2.0 * _per_position(ref.radius, layout)
                / _per_position(levels_of(ref.bits), layout))
        if not td.gadmm.quantize:
            grid = torch.zeros_like(grid)
        bound = ((tst.theta - ref.theta).abs() + 1.001 * grid + 1e-6
                 + _narrow_ulp(ref.theta_hat, layout))
        if not td.staleness:
            assert bool(((tst.theta_hat - ref.theta_hat).abs()
                         <= bound).all()), k
            assert bool(((tst.hat_edge - ref.hat_edge).abs()
                         <= bound[ttr._src]).all()), k
        assert len(tst.inbox) == len(ref.inbox) == td.staleness
        for a, b in zip(tst.inbox, ref.inbox):
            assert torch.equal(a["sent"], b["sent"]), k
            assert torch.equal(a["bits"], b["bits"]), k
            torch.testing.assert_close(a["radius"], b["radius"], rtol=1e-4,
                                       atol=0.0)
            assert a["wire"].shape == b["wire"].shape, k
            diff = float((a["wire"] != b["wire"]).float().mean()
                         if a["wire"].dtype == torch.uint8 else
                         _frac_beyond(a["wire"], b["wire"], 1e-5, layout))
            assert diff <= frac, (k, "inbox wire", diff)
        assert ttr.bit_sync(tst), k
        out.append(tm)
    return out


@pytest.mark.parametrize("bits", sorted(CASES))
def test_trainer_matches_jax(bits):
    jd, td = configs({"bits": bits})
    assert td.pack_wire == (bits <= 4)
    compare_with_jax(jd, td, CASES[bits])


def test_unported_options_raise():
    """Only the multi-GPU layouts are unported; every other option of the
    JAX DistConfig builds."""
    g = GADMMConfig(rho=1.0, qcfg=QuantizerConfig(bits=4))
    for kw in ({"uneven_shard": True}, {"seq_shard": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tq.DistConfig(num_workers=W, gadmm=g, **kw)
    for kw in ({"staleness": 1}, {"participation": 0.5}, {"mode": "jacobi"},
               {"overlap": True}, {"check_invariants": True},
               {"microbatches": 2}, {"state_dtype": torch.bfloat16},
               {"topology": "federated"}):
        tq.DistConfig(num_workers=W, gadmm=g, **kw)
    assert not tq.DistConfig(num_workers=W,
                             gadmm=GADMMConfig(quantize=False)).pack_wire


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


def test_cli_censor_layerwise_flags_on_cpu(capsys):
    """The JAX launcher's censor / layerwise flags: ``--bit-budget`` implies
    ``--layerwise``, the controller mixes widths up to 8 bits (so the wire is
    unpacked), and the step line carries ``skip=`` and ``wire_bits=``."""
    from repro_torch.launch import train
    args = train.parse_args(["--smoke", "--device", "cpu", "--steps", "2",
                             "--workers", "4", "--bits", "4",
                             "--per-worker-batch", "2", "--seq", "16",
                             "--log-every", "1", "--bit-budget", "729600",
                             "--censor"])
    trainer, state, log = train.run(args)
    out = capsys.readouterr().out
    assert "step 2: loss=" in out and " skip=" in out and " wire_bits=" in out
    dcfg = trainer.dcfg
    assert dcfg.layerwise.budget_bits == 729600 and dcfg.censor.tau == 0.05
    assert dcfg.radius_mode == "per_tensor" and not dcfg.pack_wire
    assert state.bits.shape == state.radius.shape == (4, 25)
    assert trainer.bit_sync(state)
    assert [len(m["leaf_bits_sent"]) for _, m, _ in log] == [4, 4]
