"""The paper's algorithms on the card against the same code on the CPU, and
the codec launches of each round.

Every test needs an NVIDIA GPU and nvcc; without them it skips (the fixture
decides, at run time).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_paper_gpu.py

The file imports no JAX.  Chain and graph steps run the same float32
operations on both devices, but for the local solve: one batched matrix
product, which sums in another order on each device.  So the widths and
sent masks must be equal and theta, hats and radii agree to atol 1e-5 (a
few ulp; no quantization level may move).  The duals integrate the hats:
each step adds alpha rho (hat_n - hat_m) to every edge's dual, so their
difference may grow by 2 alpha rho max |hat difference| per step, plus
1e-6 max |lam| for their own rounding; the tests hold them to that sum
over the steps taken.  The SGADMM round runs matrix products too: theta
to 1e-4 at all but 1e-3 of the positions (Adam turns ulp differences at
|g| ~ 0 into lr-sized steps), widths exact.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import gadmm
from repro_torch.core.baselines import PSProblem, run_adiana, run_gd
from repro_torch.core.censor import CensorConfig
from repro_torch.core.quantizer import QuantizerConfig
from repro_torch.core.sgadmm import SGADMMConfig, SGADMMTrainer
from repro_torch.core.topology import ring_topology
from repro_torch.data.synthetic import classification_shards, regression_shards
from repro_torch.device import generator
from repro_torch.models import mlp

pytestmark = pytest.mark.gpu

N, D = 20, 6
K1 = "quantize_dequantize"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data():
    xs, ys, _ = regression_shards(n_workers=N, samples=4000, d=D, seed=1)
    return torch.from_numpy(xs), torch.from_numpy(ys)


def _cfg(quantize=True, bits=2):
    return gadmm.GADMMConfig(rho=24.0, quantize=quantize,
                             qcfg=QuantizerConfig(bits=bits))


def _to(tup, dev):
    return type(tup)(*(x.to(dev) if isinstance(x, torch.Tensor) else x
                       for x in tup))


def _assert_close_states(a, b, fields, cfg, lam_tol: float) -> float:
    """Card state a against CPU state b after one more step; returns the
    duals' bound, grown by this step's share (see the module docstring)."""
    dhat = float((a.theta_hat.cpu() - b.theta_hat).abs().max())
    lam_tol += 2 * cfg.alpha * cfg.rho * dhat + 1e-6 * float(b.lam.abs().max())
    for f in fields:
        x, y = getattr(a, f).cpu(), getattr(b, f)
        if f in ("bits", "sent"):
            assert torch.equal(x, y), f
        else:
            tol = lam_tol if f == "lam" else 1e-5
            err = float((x - y).abs().max())
            assert err <= tol, (f, err, tol)
    return lam_tol


@pytest.mark.parametrize("quantize,bits", [(True, 2), (True, 4), (False, 2)])
def test_chain_step_card_matches_cpu(cuda, quantize, bits):
    xs, ys = _data()
    cfg = _cfg(quantize, bits)
    q = gadmm.make_quadratic(xs, ys, cfg.rho)
    states = {"cpu": gadmm.init_state(N, D, cfg, device="cpu"),
              "cuda": gadmm.init_state(N, D, cfg, device=cuda)}
    qs = {"cpu": q, "cuda": _to(q, cuda)}
    g = torch.Generator().manual_seed(0)
    lam_tol = 0.0
    for _ in range(5):
        u = [torch.rand((N, D), generator=g) for _ in range(2)]
        before = kernels.LAUNCHES[K1]
        for dev in states:
            states[dev] = gadmm.gadmm_step(states[dev], qs[dev], cfg,
                                           u=[x.to(dev) for x in u])
        assert kernels.LAUNCHES[K1] - before == (2 if quantize else 0)
        lam_tol = _assert_close_states(
            states["cuda"], states["cpu"],
            ("theta", "theta_hat", "lam", "radius", "bits"), cfg, lam_tol)


@pytest.mark.parametrize("censored", [False, True])
def test_graph_step_card_matches_cpu(cuda, censored):
    xs, ys = _data()
    topo = ring_topology(N)
    cfg = _cfg()
    cen = CensorConfig(tau=0.5, xi=0.9) if censored else None
    q = gadmm.make_graph_quadratic(xs, ys, cfg.rho, topo)
    states = {"cpu": gadmm.graph_init_state(topo, D, cfg, device="cpu"),
              "cuda": gadmm.graph_init_state(topo, D, cfg, device=cuda)}
    qs = {"cpu": q, "cuda": _to(q, cuda)}
    tcs = {dev: gadmm.graph_consts(topo, device=dev) for dev in states}
    g = torch.Generator().manual_seed(1)
    lam_tol = 0.0
    for _ in range(8):
        u = [torch.rand((N, D), generator=g) for _ in range(2)]
        before = kernels.LAUNCHES[K1]
        for dev in states:
            states[dev] = gadmm.graph_step(
                states[dev], qs[dev], cfg, topo, censor=cen,
                u=[x.to(dev) for x in u], tc=tcs[dev])
        assert kernels.LAUNCHES[K1] - before == 2
        lam_tol = _assert_close_states(
            states["cuda"], states["cpu"],
            ("theta", "theta_hat", "lam", "radius", "bits", "sent"), cfg,
            lam_tol)


def test_quantize_rows_sender_equals_receiver(cuda):
    """The hats committed on the card are bitwise the receiver's decode of
    the wire levels."""
    rng = np.random.default_rng(3)
    n, d = 64, 1000
    theta = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    hat = theta + 0.1 * torch.from_numpy(
        rng.normal(size=(n, d)).astype(np.float32))
    hat[5] = theta[5]
    active = torch.ones(n, dtype=torch.bool)
    for bits in (2, 4, 8):
        cfg = _cfg(bits=bits)
        args = [t.to(cuda) for t in (theta, hat, active,
                                     torch.rand((n, d)), torch.zeros(n),
                                     torch.full((n,), bits,
                                                dtype=torch.int32))]
        before = kernels.LAUNCHES[K1]
        h, r, b, qlev = gadmm.quantize_rows(*args, cfg)
        assert kernels.LAUNCHES[K1] == before + 1
        assert qlev.dtype == torch.uint8 and int(qlev.max()) <= 2**bits - 1
        rx = gadmm.dequantize_rows(qlev, args[1], r, b)
        assert torch.equal(rx.view(torch.int32), h.view(torch.int32))
        assert torch.equal(h[5], args[1][5])


def test_sgadmm_card_matches_cpu(cuda):
    layers = [(32, 24), (24, 10)]
    xs, ys = classification_shards(n_workers=6, samples=1800, dim=32, seed=0)
    p0 = mlp.init_params(generator(0, "cpu"), layers)
    trs = {}
    for quantize in (True, False):
        cfg = SGADMMConfig(gadmm=gadmm.GADMMConfig(
            rho=1.0, quantize=quantize, qcfg=QuantizerConfig(bits=8),
            alpha=0.01), local_iters=10, local_lr=3e-3, batch_size=64)
        trs[quantize] = {
            dev: SGADMMTrainer(mlp.loss_fn,
                               {k: v.to(dev) for k, v in p0.items()}, 6, cfg,
                               device=dev) for dev in ("cpu", cuda)}
    rng = np.random.default_rng(0)
    for _ in range(2):
        sel = rng.integers(0, xs.shape[1], size=(6, 64))
        xb = torch.from_numpy(np.take_along_axis(xs, sel[:, :, None], 1))
        yb = torch.from_numpy(np.take_along_axis(ys, sel, 1))
        u = [torch.rand((6, trs[True]["cpu"].d)) for _ in range(2)]
        for quantize, pair in trs.items():
            before = kernels.LAUNCHES[K1]
            for dev, tr in pair.items():
                tr.train_step(xb.to(dev), yb.to(dev),
                              u=[x.to(dev) for x in u])
            assert kernels.LAUNCHES[K1] - before == (2 if quantize else 0)
            a, b = pair[cuda].state, pair["cpu"].state
            assert torch.equal(a.bits.cpu(), b.bits)
            off = ((a.theta.cpu() - b.theta).abs() > 1e-4).float().mean()
            assert float(off) <= 1e-3, float(off)


def test_ps_baselines_launch_the_codec_once_per_iteration(cuda):
    xs, ys = _data()
    xs, ys = xs.to(cuda), ys.to(cuda)
    prob = PSProblem(xtx=torch.einsum("nmd,nme->nde", xs, xs),
                     xty=torch.einsum("nmd,nm->nd", xs, ys))
    for fn, want in ((lambda: run_gd(prob, 5), 0),
                     (lambda: run_gd(prob, 5, quantize_bits=2), 5),
                     (lambda: run_adiana(prob, 5, bits=2), 5)):
        before = kernels.LAUNCHES[K1]
        out, _ = fn()
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[K1] - before == want
        assert out.device.type == "cuda" and torch.isfinite(out).all()
