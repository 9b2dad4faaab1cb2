"""The port's censoring rule (``repro_torch.core.censor``) against the JAX
package's ``repro.core.censor`` under ``jax.jit``, on shared numpy inputs.

``threshold`` agrees to rtol 1e-6 (two float32 ``pow`` implementations),
``delta_sq`` to rtol 1e-5 (float32 sums in another order within a leaf),
and ``transmit_mask`` exactly, on deltas kept at least 1% away from the
threshold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import censor as jc
from repro_torch.core import censor as tc

SHAPES = [(3, 5), (0,), (7,), (2, 4, 6)]     # one zero-size leaf


def _leaves(seed, w=6, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.normal(size=(w,) + s)).astype(np.float32)
            for s in SHAPES]


def test_flag_bits_and_config():
    assert tc.FLAG_BITS == jc.FLAG_BITS == 1
    assert tc.CensorConfig() == tc.CensorConfig(tau=jc.CensorConfig().tau,
                                                xi=jc.CensorConfig().xi)
    with pytest.raises(AssertionError):
        tc.CensorConfig(tau=0.0)
    with pytest.raises(AssertionError):
        tc.CensorConfig(xi=1.0)


@pytest.mark.parametrize("tau,xi", [(0.05, 0.9), (14.0, 0.9), (2.0, 0.5)])
def test_threshold_matches_jax(tau, xi):
    f = jax.jit(lambda k: jc.threshold(jc.CensorConfig(tau, xi), k))
    for k in range(0, 40, 3):
        got = tc.threshold(tc.CensorConfig(tau, xi), k)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(f(jnp.int32(k))),
                                   rtol=1e-6)


def test_delta_sq_matches_jax():
    a, b = _leaves(0), _leaves(1)
    want = jax.jit(jc.delta_sq)(a, b)
    got = tc.delta_sq([torch.from_numpy(x) for x in a],
                      [torch.from_numpy(x) for x in b])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("step", [0, 1, 5])
def test_transmit_mask_matches_jax(step):
    cfg_j, cfg_t = jc.CensorConfig(tau=3.0, xi=0.8), tc.CensorConfig(3.0, 0.8)
    prev = _leaves(2)
    # per-worker moves of L2 size spread around the threshold
    rng = np.random.default_rng(3)
    d = _leaves(4)
    norm = np.sqrt(sum((x.reshape(6, -1) ** 2).sum(1) for x in d))
    target = float(tc.threshold(cfg_t, step)) * np.array(
        [0.5, 0.98, 1.02, 1.5, 0.2, 3.0], np.float32)
    rng.shuffle(target)
    new = [(p + x * (target / norm).reshape((6,) + (1,) * (x.ndim - 1))
            ).astype(np.float32) for p, x in zip(prev, d)]
    dist = np.sqrt(np.asarray(jax.jit(jc.delta_sq)(new, prev)))
    thr = float(tc.threshold(cfg_t, step))
    assert np.all(np.abs(dist / thr - 1.0) > 0.01)
    want = jax.jit(lambda a, b, k: jc.transmit_mask(a, b, cfg_j, k))(
        new, prev, jnp.int32(step))
    got = tc.transmit_mask([torch.from_numpy(x) for x in new],
                           [torch.from_numpy(x) for x in prev], cfg_t, step)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < 6
