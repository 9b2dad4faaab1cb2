"""The port's bit-width rules against the JAX package's, on shared numpy
inputs: the eq. 11 bit-growth rule ``_next_bits``, the bit-budget
controller ``allocate_bits`` and ``LayerwiseConfig.resolve``.  All results
must be equal.  The JAX functions run under ``jax.jit``, as in the trainer's
step, where XLA fuses ``1 + levels * ratio`` into one multiply-add and
computes log2 as a product with a reciprocal; the port reproduces both.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import whisper_tiny as j_whisper
from repro.core import quantizer as jqz
from repro.models import encdec as j_encdec
from repro_torch.core import quantizer as tqz


def _leaf_sizes(cfg):
    shapes = jax.eval_shape(lambda k: j_encdec.init(k, cfg),
                            jax.random.PRNGKey(0))
    return [math.prod(x.shape) for x in jax.tree.leaves(shapes)]


SIZES = {"whisper-tiny": _leaf_sizes(j_whisper.config()),
         "whisper-tiny-smoke": _leaf_sizes(j_whisper.smoke_config())}


def _next_bits_inputs(seed):
    """(W, L) bits_prev, r_new, r_prev with ratios exactly 1, 0.5 and 2,
    random ratios, r_prev == 0, and (rows 5-7) ratios a few ulp from those
    that put 1 + levels * ratio on a power of two, where the rounding of
    the product and of log2 decides the width."""
    rng = np.random.default_rng(seed)
    w, n = 8, 64
    bits_prev = rng.integers(1, 9, (w, n)).astype(np.int32)
    r_prev = rng.random((w, n)).astype(np.float32) + np.float32(1e-3)
    ratio = (3.0 * rng.random((w, n))).astype(np.float32)
    ratio[0], ratio[1], ratio[2] = 1.0, 0.5, 2.0
    r_new = (r_prev * ratio).astype(np.float32)
    r_prev[3, ::2] = 0.0
    r_new[4, :8] = 0.0
    for row in (5, 6, 7):
        for j in range(n):
            levels = 2.0 ** int(bits_prev[row, j]) - 1.0
            edge = np.float32((2.0 ** (j % 8 + 1) - 1.0) / levels)
            step = (j // 8) % 7 - 3 + 7 * (row - 6)
            r_new[row, j] = edge
            for _ in range(abs(step)):
                r_new[row, j] = np.nextafter(r_new[row, j], np.float32(
                    np.sign(step) * np.inf))
            r_prev[row, j] = 1.0
    return bits_prev, r_new, r_prev


@pytest.mark.parametrize("adapt", [True, False])
@pytest.mark.parametrize("max_bits", [4, 8])
def test_next_bits_matches_jax(adapt, max_bits):
    bits_prev, r_new, r_prev = _next_bits_inputs(0)
    base = np.arange(64, dtype=np.int32) % max_bits + 1
    for base_bits in (None, base[None]):
        jcfg = jqz.QuantizerConfig(bits=min(4, max_bits), adapt_bits=adapt,
                                   max_bits=max_bits)
        tcfg = tqz.QuantizerConfig(bits=min(4, max_bits), adapt_bits=adapt,
                                   max_bits=max_bits)
        want = jax.jit(lambda a, b, c: jqz._next_bits(
            jcfg, a, b, c, base_bits=base_bits))(bits_prev, r_new, r_prev)
        got = tqz._next_bits(
            tcfg, torch.from_numpy(bits_prev), torch.from_numpy(r_new),
            torch.from_numpy(r_prev),
            base_bits=None if base_bits is None else torch.from_numpy(base_bits))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if adapt:
        # ratio exactly 1 keeps the width; 0.5 / 2 move it by about one bit
        np.testing.assert_array_equal(got[0].numpy(), bits_prev[0].clip(
            1, max_bits))


@pytest.mark.parametrize("model", sorted(SIZES))
@pytest.mark.parametrize("per_param", [0.5, 1.0, 2.5, 4.0, 8.0])
def test_allocate_bits_matches_jax(model, per_param):
    sizes = np.asarray(SIZES[model], np.float32)
    assert len(sizes) == 25
    budget = int(per_param * float(sizes.sum()))
    rng = np.random.default_rng(1)
    scores = rng.random((4, sizes.size)).astype(np.float32)
    scores[:, 5:12] = scores[:, 4:5]            # tied scores
    scores[1] = 0.0                             # all tied
    scores[2, ::3] = 0.0
    for lo, hi in ((1, 8), (2, 6)):
        want = jax.jit(lambda s: jqz.allocate_bits(s, sizes, budget, lo, hi))(
            scores)
        got = tqz.allocate_bits(torch.from_numpy(scores), sizes, budget, lo,
                                hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(got.min()) >= lo and int(got.max()) <= hi


@pytest.mark.parametrize("kw", [
    {},
    {"bits": 3, "periods": 2},
    {"bits": tuple(range(1, 9)) * 3 + (4,), "periods": (1, 2, 3) * 8 + (1,)},
    {"large_leaf_period": 3},
    {"large_leaf_period": 2, "large_leaf_frac": 0.3, "taus": 0.5,
     "tau_xi": 0.9},
    {"large_leaf_period": 2, "periods": (1,) * 25, "taus": tuple(
        0.1 * i for i in range(25))},
    {"adapt_bits": True, "budget_bits": 1000, "min_bits": 2, "max_bits": 6},
])
def test_layerwise_resolve_matches_jax(kw):
    for sizes in SIZES.values():
        for base in (2, 4):
            want = jqz.LayerwiseConfig(**kw).resolve(sizes, base)
            got = tqz.LayerwiseConfig(**kw).resolve(sizes, base)
            assert got == want


# ------------------------------------------- the per-tensor tree codec -----
def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 7)).astype(np.float32),
            "b": {"c": rng.normal(size=(11,)).astype(np.float32),
                  "d": np.zeros((3,), np.float32)}}


@pytest.mark.parametrize("adapt", [False, True])
def test_tree_quantize_matches_jax(adapt):
    """quantize / dequantize / global_radius / payload_bits on a nested
    tree, two rounds, against the un-jitted JAX functions with the JAX
    per-leaf draws (``split(key, L)``): levels, radii, widths and hats
    bitwise equal; the receiver's hats equal the sender's bitwise."""
    from repro_torch.convert import params_from_jax
    jcfg = jqz.QuantizerConfig(bits=3, adapt_bits=adapt)
    tcfg = tqz.QuantizerConfig(bits=3, adapt_bits=adapt)
    theta0 = jax.tree.map(jnp.asarray, _tree(0))
    jst = jqz.init_state(theta0, jcfg)
    tst = tqz.init_state(params_from_jax(_tree(0), "cpu"), tcfg)
    for k, seed in enumerate((0, 1)):
        theta = jax.tree.map(jnp.asarray, _tree(seed))
        key = jax.random.PRNGKey(k)
        keys = jax.random.split(key, len(jax.tree.leaves(theta)))
        u = [torch.from_numpy(np.array(jax.random.uniform(kk, x.shape)))
             for kk, x in zip(keys, jax.tree.leaves(theta))]
        with jax.disable_jit():
            jpay, jst_new = jqz.quantize(theta, jst, key, jcfg)
            jrx = jqz.dequantize(jpay, jst.theta_hat)
        tpay, tst_new = tqz.quantize(params_from_jax(_tree(seed), "cpu"), tst,
                                     u, tcfg)
        trx = tqz.dequantize(tpay, tst.theta_hat)
        assert float(tpay["radius"]) == float(jpay["radius"])
        assert int(tpay["bits"]) == int(jpay["bits"])
        for path in (("a",), ("b", "c"), ("b", "d")):
            get = lambda t: t[path[0]] if len(path) == 1 else t[path[0]][path[1]]
            np.testing.assert_array_equal(get(tpay["q"]).numpy(),
                                          np.asarray(get(jpay["q"])))
            np.testing.assert_array_equal(get(tst_new.theta_hat).numpy(),
                                          np.asarray(get(jst_new.theta_hat)))
            np.testing.assert_array_equal(get(trx).numpy(), np.asarray(get(jrx)))
            assert torch.equal(get(trx), get(tst_new.theta_hat))
        jst, tst = jst_new, tst_new
    assert tqz.payload_bits(tcfg, 49) == jqz.payload_bits(jcfg, 49)
    assert tqz.payload_bits(4, 10, num_radii=3) == \
        jqz.payload_bits(4, 10, num_radii=3)


def test_quantize_tensor_zero_radius_and_generator():
    """R == 0: levels 0 and the hat unchanged; a generator draws u on the
    tensor's device; float64 raises naming the ROADMAP item."""
    theta = torch.randn(3, 4)
    q, hat = tqz.quantize_tensor(theta, theta.clone(), torch.Generator(),
                                 radius=torch.tensor(0.0),
                                 bits=torch.tensor(4))
    assert not q.any() and torch.equal(hat, theta)
    with pytest.raises(TypeError, match="item 11"):
        tqz.quantize_tensor(theta.double(), theta.double(), torch.Generator(),
                            radius=torch.tensor(1.0), bits=torch.tensor(4))
