"""The port's parameter-server baselines (GD, QGD, ADIANA) against the JAX
package, on the CPU, on ``tests/test_gadmm.py``'s problem (N 20, d 6).

The quantized runs consume the JAX run's own draws: per iteration
``key, sub = split(key)``, then one (d,) uniform per worker from
``split(sub, N)``.  Both sides run 400 iterations with the same step size
(GD / QGD: 1 / L from the JAX eigenvalue).

Tolerances: bits per iteration exact; GD's iterates to atol 1e-5 (2.4e-7
measured).  The jitted reference folds the constant levels 2^b - 1 into a
reciprocal and contracts its FMAs, and the port's gradient is one batched
product that sums in another order, so the gradients and steps differ by
ulps, and now and then a level moves by one at a rounding
edge (at seed 0: QGD 4-bit first at iteration 77, ADIANA 4-bit at 19; none
in 400 iterations at 2 bits; over seeds 0-2 never before iteration 8).  A
moved level shifts one worker's gradient by one quantization step, and the
runs then differ by quantization noise, which the iterate bounds hold:
the first 8 iterates to atol 1e-5 and all 400 to 5e-4 (QGD; measured
1.1e-4 at seed 0, 3.5e-4 at most over seeds 0-2, under its 7e-4 variance
floor at 2 bits) or 1e-4 (ADIANA; 2.9e-5 and 5.1e-5).  ``_stoch_quantize``
alone equals the un-jitted JAX function bitwise.  L and mu (eigenvalues,
LAPACK on both sides) agree to rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.data.synthetic import regression_shards
from repro_torch.core import baselines as tb

N, D, ITERS = 20, 6, 400


@pytest.fixture(scope="module")
def problems():
    xs, ys, _ = regression_shards(n_workers=N, samples=4000, d=D, seed=1)
    xs, ys = jnp.asarray(xs), jnp.asarray(ys)
    xtx = jnp.einsum("nmd,nme->nde", xs, xs)
    xty = jnp.einsum("nmd,nm->nd", xs, ys)
    theta_star = np.linalg.solve(np.asarray(xtx, np.float64).sum(0),
                                 np.asarray(xty, np.float64).sum(0))
    return (jb.PSProblem(xtx=xtx, xty=xty),
            tb.PSProblem(xtx=torch.from_numpy(np.array(xtx)),
                         xty=torch.from_numpy(np.array(xty))), theta_star)


def jax_draws(seed, iters=ITERS):
    """(iters, N, d): the draws run_gd / run_adiana take with `seed`."""
    def body(key, _):
        key, sub = jax.random.split(key)
        u = jax.vmap(lambda k: jax.random.uniform(k, (D,)))(
            jax.random.split(sub, N))
        return key, u
    _, u = jax.jit(lambda k: jax.lax.scan(body, k, None, length=iters))(
        jax.random.PRNGKey(seed))
    return torch.from_numpy(np.array(u))


def test_problem_matches_jax(problems):
    jp, tp, _ = problems
    theta = np.linspace(-1.0, 1.0, D).astype(np.float32)
    np.testing.assert_allclose(tp.grad(torch.from_numpy(theta)).numpy(),
                               np.asarray(jp.grad(jnp.asarray(theta))),
                               rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(float(tp.objective(torch.from_numpy(theta))),
                               float(jp.objective(jnp.asarray(theta))),
                               rtol=1e-6)
    np.testing.assert_allclose(tp.lipschitz(), jp.lipschitz(), rtol=1e-6)
    np.testing.assert_allclose(tp.strong_convexity(), jp.strong_convexity(),
                               rtol=1e-6)
    assert (tp.n, tp.d) == (jp.n, jp.d) == (N, D)


@pytest.mark.parametrize("bits", [2, 4])
def test_stoch_quantize_matches_eager_jax(bits):
    """The codec with a zero previous hat against the JAX function, per row
    (vmap), un-jitted: equal, including an all-zero row (returned as is)."""
    rng = np.random.default_rng(bits)
    g = (100.0 * rng.normal(size=(N, D))).astype(np.float32)
    g[3] = 0.0
    keys = jax.random.split(jax.random.PRNGKey(bits), N)
    u = np.stack([np.array(jax.random.uniform(k, (D,))) for k in keys])
    with jax.disable_jit():
        want = np.stack([np.asarray(jb._stoch_quantize(jnp.asarray(g[i]),
                                                       keys[i], bits))
                         for i in range(N)])
    got = tb._stoch_quantize(torch.from_numpy(g), torch.from_numpy(u), bits)
    np.testing.assert_array_equal(got.numpy(), want)


def _assert_iterates(got, want, atol):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got[:8], want[:8], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("quantize_bits,atol", [(None, 1e-5), (2, 5e-4),
                                                (4, 5e-4)])
def test_run_gd_matches_jax(problems, quantize_bits, atol):
    jp, tp, _ = problems
    lr = 1.0 / jp.lipschitz()
    j_th, j_bits = jb.run_gd(jp, ITERS, lr=lr, quantize_bits=quantize_bits)
    u = jax_draws(0) if quantize_bits else None
    t_th, t_bits = tb.run_gd(tp, ITERS, lr=lr, quantize_bits=quantize_bits,
                             u=u)
    assert t_bits == j_bits
    _assert_iterates(t_th, j_th, atol)


@pytest.mark.parametrize("bits", [2, 4])
def test_run_adiana_matches_jax(problems, bits):
    jp, tp, _ = problems
    j_ys, j_bits = jb.run_adiana(jp, ITERS, bits=bits)
    t_ys, t_bits = tb.run_adiana(tp, ITERS, bits=bits, u=jax_draws(0))
    assert t_bits == j_bits
    _assert_iterates(t_ys, j_ys, 1e-4)


def test_baselines_converge_on_their_own_draws(problems):
    """tests/test_gadmm.py's bounds, with the port's generator."""
    _, tp, theta_star = problems
    err = lambda th: float(np.abs(th.numpy() - theta_star).max())
    thetas, bits_gd = tb.run_gd(tp, ITERS)
    assert err(thetas[-1]) < 1e-2
    ys, bits_ad = tb.run_adiana(tp, ITERS, bits=2)
    assert err(ys[-1]) < 5e-2
    assert bits_ad < bits_gd
    thetas, _ = tb.run_gd(tp, ITERS, quantize_bits=2)
    assert err(thetas[-1]) < 0.3


def test_float64_raises(problems):
    _, tp, _ = problems
    with pytest.raises(TypeError, match="item 11"):
        tb.PSProblem(xtx=tp.xtx.double(), xty=tp.xty.double())
    with pytest.raises(TypeError, match="item 11"):
        tb._stoch_quantize(torch.ones((N, D), dtype=torch.float64),
                           torch.zeros((N, D)), 2)
