"""The port's codec (plain version, CPU) against the JAX package's.

Inputs are numpy draws shared by both sides.  The oracle is
``repro.kernels.quantize.ref.quantize_dequantize_ref`` under ``jax.jit`` and
the Pallas kernel ``quantize.quantize_dequantize`` in interpret mode.  Levels
must be equal exactly.  Hats: found bitwise wherever XLA kept the arithmetic
as written; elsewhere XLA:CPU contracts h + step*q into an FMA under jit, and
the JAX hat is then bitwise ``round(fma(step, q, h)) - R`` — 1 ulp of that
intermediate sum from the port's, which rounds every operation as its CUDA
kernel does, so that its receivers decode the sender's hat bitwise.  The
port's CUDA kernel is held against this plain version on the card
(tests/test_torch_kernels_gpu.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quantize import quantize as jq_kernel
from repro.kernels.quantize import ref as jq_ref
from repro_torch.kernels.quantize import ops as tq

SIZES = [1, 127, 128, 129, 700, 33_000]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_jit_ref = jax.jit(jq_ref.quantize_dequantize_ref)
_jit_kernel = jax.jit(lambda *a: jq_kernel.quantize_dequantize(*a, interpret=True))


def _inputs(rows, n, seed):
    rng = np.random.default_rng(seed)
    theta = rng.normal(size=(rows, n)).astype(np.float32)
    hat = (0.5 * rng.normal(size=(rows, n))).astype(np.float32)
    u = rng.random((rows, n), dtype=np.float32)
    return theta, hat, u


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _to_np(x):
    return np.asarray(x.float() if x.dtype == torch.bfloat16 else x)


def _check(q_t, h_t, q_j, h_j, hat_prev, radius, levels):
    """q exact; each JAX hat either bitwise the port's, or bitwise the
    FMA-contracted form round(round(fma(step, q, h)) - R) that XLA:CPU
    computes under jit (f64 emulation: the product of two f32 is exact)."""
    np.testing.assert_array_equal(np.asarray(q_t), np.asarray(q_j))
    ht = h_t.to(torch.float32).numpy()
    hj = np.asarray(jnp.asarray(h_j).astype(jnp.float32))
    h = np.asarray(hat_prev, np.float32)
    r = np.broadcast_to(np.float32(radius), h.shape)
    step = (np.float32(2.0) * np.maximum(r, np.float32(1e-30))
            / np.float32(levels)).astype(np.float32)
    fused = (h.astype(np.float64) + step.astype(np.float64)
             * np.asarray(q_t, np.float64)).astype(np.float32)
    fused = np.where(r > 0, (fused - r).astype(np.float32), h)
    if h_t.dtype == torch.bfloat16:
        fused = torch.from_numpy(fused).bfloat16().float().numpy()
    same = _bits(ht) == _bits(hj)
    contracted = _bits(fused) == _bits(hj)
    assert np.all(same | contracted), np.abs(ht - hj)[~(same | contracted)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_codec_scalar_radius_matches_jax(n, dtype):
    """K1 form: one R and one levels value per row (the trainer's (W,)
    radius), against the JAX scalar-R functions row by row; row 1 has R = 0
    (q = 0, hat unchanged)."""
    jdt, tdt = DTYPES[dtype]
    theta, hat, u = _inputs(2, n, n)
    theta_j = jnp.asarray(theta).astype(jdt)
    hat_j = jnp.asarray(hat).astype(jdt)
    r = np.abs(np.asarray(theta_j, np.float32)
               - np.asarray(hat_j, np.float32)).max(axis=1)
    r[1] = 0.0
    levels = np.float32(15.0)
    q_t, h_t = tq.quantize_dequantize(
        torch.tensor(np.asarray(theta_j, np.float32)).to(tdt),
        torch.tensor(np.asarray(hat_j, np.float32)).to(tdt),
        torch.from_numpy(u), torch.from_numpy(r), float(levels))
    for i in range(2):
        for fn in (_jit_ref, _jit_kernel):
            q_j, h_j = fn(theta_j[i], hat_j[i], jnp.asarray(u[i]),
                          jnp.float32(r[i]), jnp.float32(levels))
            _check(q_t[i], h_t[i], q_j, h_j, np.asarray(hat_j[i], np.float32),
                   r[i], levels)
    assert int(q_t[1].max()) == 0
    np.testing.assert_array_equal(_to_np(h_t[1]),
                                  np.asarray(hat_j[1], np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("vec_levels", [False, True], ids=["vec_r", "vec_rl"])
def test_codec_per_element_matches_jax(n, dtype, vec_levels):
    """K2 (per-element R) and K3 (per-element R and levels): two segments
    with their own radius (and bit width), the second with R = 0."""
    jdt, tdt = DTYPES[dtype]
    theta, hat, u = _inputs(1, n, n + 1)
    theta_j = jnp.asarray(theta[0]).astype(jdt)
    hat_j = jnp.asarray(hat[0]).astype(jdt)
    cut = max(1, (2 * n) // 3)
    diff = np.abs(np.asarray(theta_j, np.float32) - np.asarray(hat_j, np.float32))
    radius = np.zeros((n,), np.float32)
    radius[:cut] = diff[:cut].max()
    if vec_levels:
        levels = np.full((n,), 15.0, np.float32)
        levels[: cut // 2] = 3.0
        lv_t = torch.from_numpy(levels)
    else:
        levels = np.float32(15.0)
        lv_t = float(levels)
    q_t, h_t = tq.quantize_dequantize(
        torch.tensor(np.asarray(theta_j, np.float32)).to(tdt),
        torch.tensor(np.asarray(hat_j, np.float32)).to(tdt),
        torch.from_numpy(u[0]), torch.from_numpy(radius), lv_t)
    for fn in (_jit_ref, _jit_kernel):
        q_j, h_j = fn(theta_j, hat_j, jnp.asarray(u[0]), jnp.asarray(radius),
                      jnp.asarray(levels))
        _check(q_t, h_t, q_j, h_j, np.asarray(hat_j, np.float32), radius,
               levels)
    assert not q_t[cut:].any()


def test_decode_reproduces_sender_hat():
    """The receiver's plain decode of the levels gives the sender's hat
    bitwise (the sender == receiver invariant of the trainer's wire)."""
    theta, hat, u = _inputs(3, 1000, 5)
    th, h, uu = map(torch.from_numpy, (theta, hat, u))
    r = (th - h).abs().amax(dim=1)
    r[2] = 0.0
    lv = torch.tensor([15.0, 3.0, 255.0])
    q, hat_new = tq.quantize_dequantize(th, h, uu, r, lv)
    dec = tq.decode_ref(h, q, r[:, None], lv[:, None])
    assert torch.equal(dec.view(torch.int32), hat_new.view(torch.int32))


def test_wrapper_rejects_bad_shapes():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        tq.quantize_dequantize(x, x, x, torch.zeros(3), 15.0)
    with pytest.raises(TypeError):
        tq.quantize_dequantize(x, x, x.double(), 1.0, 15.0)
