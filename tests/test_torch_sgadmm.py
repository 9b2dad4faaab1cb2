"""The port's Q-SGADMM and the paper's MLP against the JAX package, on the
CPU, at ``tests/test_sgadmm.py``'s smoke size (32 -> 24 -> 10, N 6 workers,
batch 64, rho 1, alpha 0.01, 10 local Adam steps at lr 3e-3, 8 bits).

Tolerances:
- The MLP (forward, loss, accuracy) on shared weights: rtol 1e-5 (matrix
  products summed in another order); the worker-batched form equals the
  per-worker one to 1e-6.
- One round from a shared state (3 JAX rounds in) with the JAX draws:
  widths and Adam counters exact; theta, Adam moments and duals to atol
  1e-5 (1e-7 measured: the gradients differ by ulps, autograd and
  jax.grad add the terms in other orders); hats to atol 1e-5 except where
  a level moved by one at a rounding edge (a step of 2R/255), at most 1e-3
  of the positions (0 measured in round 1 of this test; 3.2e-4 in a
  second round).  Over several rounds Adam turns ulp differences at
  |g| ~ 0 into lr-sized steps, so the runs are compared by outcome: the
  port's 40 rounds reach the JAX test's accuracy bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gadmm import GADMMConfig as JGADMMConfig
from repro.core.quantizer import QuantizerConfig as JQuantizerConfig
from repro.core.sgadmm import SGADMMConfig as JSGADMMConfig
from repro.core.sgadmm import SGADMMTrainer as JSGADMMTrainer
from repro.models import mlp as jmlp
from repro_torch.convert import params_from_jax, sgadmm_state_from_jax
from repro_torch.core.gadmm import GADMMConfig
from repro_torch.core.quantizer import QuantizerConfig
from repro_torch.core.sgadmm import SGADMMConfig, SGADMMTrainer
from repro_torch.data.synthetic import classification_shards
from repro_torch.device import generator
from repro_torch.models import mlp as tmlp

N, BATCH = 6, 64
LAYERS = [(32, 24), (24, 10)]


@pytest.fixture(scope="module")
def data():
    return classification_shards(n_workers=N, samples=1800, dim=32, seed=0)


def _cfg(pkg, quantize, bits=8):
    g, q, s = ((JGADMMConfig, JQuantizerConfig, JSGADMMConfig) if pkg == "jax"
               else (GADMMConfig, QuantizerConfig, SGADMMConfig))
    return s(gadmm=g(rho=1.0, quantize=quantize, qcfg=q(bits=bits),
                     alpha=0.01),
             local_iters=10, local_lr=3e-3, batch_size=BATCH)


def _batches(xs, ys, seed=0):
    rng = np.random.default_rng(seed)
    while True:
        sel = rng.integers(0, xs.shape[1], size=(xs.shape[0], BATCH))
        yield (np.take_along_axis(xs, sel[:, :, None], axis=1),
               np.take_along_axis(ys, sel, axis=1))


def test_mlp_matches_jax(data):
    xs, ys = data
    jp = jmlp.init_params(jax.random.PRNGKey(0), layers=LAYERS)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x, y = xs[0], ys[0]
    np.testing.assert_allclose(tmlp.apply(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jmlp.apply(jp, x)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        float(tmlp.loss_fn(tp, torch.from_numpy(x), torch.from_numpy(y))),
        float(jmlp.loss_fn(jp, x, y)), rtol=1e-5)
    # the same predictions; the mean of the hits rounds in another order
    np.testing.assert_array_equal(
        torch.argmax(tmlp.apply(tp, torch.from_numpy(x)), dim=-1).numpy(),
        np.asarray(jnp.argmax(jmlp.apply(jp, x), axis=-1)))
    np.testing.assert_allclose(
        float(tmlp.accuracy(tp, torch.from_numpy(x), torch.from_numpy(y))),
        float(jmlp.accuracy(jp, x, y)), rtol=1e-6)
    # stacked over workers: one bmm per layer, (N,) losses
    stacked = {k: v[None].repeat(N, *([1] * v.dim())) for k, v in tp.items()}
    per = tmlp.loss_fn(stacked, torch.from_numpy(xs[:, :BATCH]),
                       torch.from_numpy(ys[:, :BATCH]))
    assert per.shape == (N,)
    for w in range(N):
        np.testing.assert_allclose(
            float(per[w]), float(tmlp.loss_fn(tp, torch.from_numpy(
                xs[w, :BATCH]), torch.from_numpy(ys[w, :BATCH]))), rtol=1e-6)
    assert tmlp.num_params() == jmlp.num_params() == 109_386
    g = tmlp.init_params(generator(0, "cpu"))
    assert sorted(g) == ["b0", "b1", "b2", "w0", "w1", "w2"]
    assert all(g[f"w{i}"].shape == s for i, s in enumerate(tmlp.LAYERS))


@pytest.mark.parametrize("quantize", [True, False])
def test_one_round_matches_jax(data, quantize):
    xs, ys = data
    p0 = jmlp.init_params(jax.random.PRNGKey(0), layers=LAYERS)
    jtr = JSGADMMTrainer(jmlp.loss_fn, p0, N, _cfg("jax", quantize))
    ttr = SGADMMTrainer(tmlp.loss_fn,
                        params_from_jax(jax.tree.map(np.asarray, p0), "cpu"),
                        N, _cfg("torch", quantize), device="cpu")
    assert ttr.d == jtr.d
    np.testing.assert_array_equal(ttr.state.theta.numpy(),
                                  np.asarray(jtr.state.theta))
    batches = _batches(xs, ys)
    for _ in range(3):
        jtr.train_step(*map(jnp.asarray, next(batches)))
    ttr.state = sgadmm_state_from_jax(jax.tree.map(np.asarray, jtr.state),
                                      "cpu")
    xb, yb = next(batches)
    _, k_h, k_t = jax.random.split(jtr.state.key, 3)
    u = [torch.from_numpy(np.array(jax.random.uniform(k, (N, ttr.d))))
         for k in (k_h, k_t)]
    jtr.train_step(jnp.asarray(xb), jnp.asarray(yb))
    ttr.train_step(torch.from_numpy(xb), torch.from_numpy(yb), u=u)
    js, ts = jtr.state, ttr.state
    assert ts.step == int(js.step) == 4
    for f in ("bits", "adam_t"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    for f in ("theta", "adam_mu", "adam_nu", "lam", "radius"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=0,
                                   atol=1e-5, err_msg=f)
    off = np.abs(ts.theta_hat.numpy() - np.asarray(js.theta_hat)) > 1e-5
    assert off.mean() <= 1e-3, off.mean()
    if not quantize:
        assert torch.equal(ts.theta_hat, ts.theta)
    assert ttr.bits_per_round() == jtr.bits_per_round()


def test_40_rounds_reach_the_jax_tests_bounds(data):
    """tests/test_sgadmm.py's outcomes on the port's own draws: Q-SGADMM's
    consensus accuracy > 0.8 and within 0.08 of SGADMM's, at under 1/3.5 of
    its bits; workers within 0.35 max |theta| of their mean."""
    xs, ys = data
    x_all = torch.from_numpy(xs.reshape(-1, xs.shape[-1]))
    y_all = torch.from_numpy(ys.reshape(-1))
    accs, trainers = {}, {}
    for quantize in (True, False):
        tr = SGADMMTrainer(tmlp.loss_fn,
                           tmlp.init_params(generator(0, "cpu"), LAYERS), N,
                           _cfg("torch", quantize), device="cpu")
        batches = _batches(xs, ys)
        for _ in range(40):
            tr.train_step(*map(torch.from_numpy, next(batches)))
        accs[quantize] = float(tmlp.accuracy(tr.mean_params(), x_all, y_all))
        trainers[quantize] = tr
    assert accs[True] > 0.8, accs
    assert accs[True] > accs[False] - 0.08, accs
    assert trainers[True].bits_per_round() < \
        trainers[False].bits_per_round() / 3.5
    theta = trainers[True].state.theta
    spread = float((theta - theta.mean(0, keepdim=True)).abs().max())
    assert spread < 0.35 * float(theta.abs().max())


def test_float64_parameters_raise():
    p = tmlp.init_params(generator(0, "cpu"), LAYERS)
    p["w0"] = p["w0"].double()
    with pytest.raises(TypeError, match="item 11"):
        SGADMMTrainer(tmlp.loss_fn, p, N, _cfg("torch", True), device="cpu")
