"""The port's live invariants (``repro_torch.obs.checks``, the trainer half
of ``repro/obs/checks.py``) on the port's own trainer at whisper-tiny-smoke
on the CPU: they pass on real steps of every billing branch (static,
censored, participation, layerwise, full precision, jacobi,
staleness), raise on a
corrupted wire-bits record and on a broken dual mirror, and read the
``REPRO_CHECK`` switch.  No JAX."""
import pytest
import torch

from repro_torch.configs import whisper_tiny
from repro_torch.core.censor import CensorConfig
from repro_torch.core.gadmm import GADMMConfig
from repro_torch.core.quantizer import LayerwiseConfig, QuantizerConfig
from repro_torch.data.pipeline import ExtraInputs, LMShardLoader
from repro_torch.dist import qgadmm as tq
from repro_torch.models import encdec
from repro_torch.obs import checks

W = 4


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one intra-op thread (see test_torch_trainer.one_thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    "static": {},
    "censor": dict(censor=CensorConfig(tau=14.0, xi=0.9)),
    "participation": dict(participation=0.5, topology="ring"),
    "layerwise": dict(layerwise=LayerwiseConfig(bits=4)),
    "full_precision": dict(gadmm=GADMMConfig(rho=1.0, quantize=False)),
    "jacobi": dict(mode="jacobi"),
    "staleness": dict(staleness=2, topology="ring"),
}


def _records(steps=2, **kw):
    cfg = whisper_tiny.smoke_config()
    kw.setdefault("gadmm", GADMMConfig(rho=1.0, alpha=0.01,
                                       qcfg=QuantizerConfig(bits=4)))
    dcfg = tq.DistConfig(num_workers=W, **kw)
    tr = tq.QGADMMTrainer(encdec, cfg, dcfg, device="cpu")
    st = tq.init_state(lambda g: encdec.init(g, cfg), 0, dcfg, device="cpu")
    loader = LMShardLoader(W, 2, 16, cfg.vocab)
    frames = ExtraInputs.frames(W, 2, cfg.encoder_frames, cfg.d_model)
    recs = []
    for k in range(steps):
        st, m = tr.step(st, dict(loader.next_batch(), frames=frames))
        recs.append({"step": k, "metrics": {
            n: float(v) for n, v in m.items() if v.dim() == 0}})
    return tr, st, recs


@pytest.mark.parametrize("case", sorted(CASES))
def test_checks_pass_on_real_steps(case):
    tr, st, recs = _records(**CASES[case])
    checks.check_step_window(tr, st, recs)
    checks.check_edge_mirrors(tr, st)


def test_checks_raise_on_corruption(monkeypatch):
    tr, st, recs = _records(censor=CensorConfig(tau=14.0, xi=0.9))
    bad = [{"step": r["step"], "metrics": dict(r["metrics"])} for r in recs]
    bad[1]["metrics"]["wire_bits_per_round"] += 8.0
    with pytest.raises(checks.ObsCheckError, match="payload\\+header"):
        checks.check_step_window(tr, st, bad)
    bad = [{"step": r["step"], "metrics": dict(r["metrics"])} for r in recs]
    bad[0]["metrics"]["wire_bits_payload"] += 8.0
    bad[0]["metrics"]["wire_bits_per_round"] += 8.0
    with pytest.raises(checks.ObsCheckError, match="row_bits"):
        checks.check_step_window(tr, st, bad)
    no_tel = [{"step": 0, "metrics": {"wire_bits_per_round": 1.0}}]
    with pytest.raises(checks.ObsCheckError, match="telemetry"):
        checks.check_step_window(tr, st, no_tel)
    st.lam_edge[1, 5] += 1.0 + 10 * float(st.lam_edge.abs().max())
    with pytest.raises(checks.ObsCheckError, match="mirror broken"):
        checks.check_edge_mirrors(tr, st)
    monkeypatch.setenv(checks.ENV_FLAG, "1")
    assert checks.enabled()
    monkeypatch.setenv(checks.ENV_FLAG, "0")
    assert not checks.enabled() and checks.enabled(tr.dcfg) is False
    assert checks.enabled(tq.DistConfig(
        num_workers=W, gadmm=tr.dcfg.gadmm, check_invariants=True))
