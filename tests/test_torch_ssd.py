"""The plain version of the port's intra-chunk SSD kernel (K6,
``repro_torch.kernels.ssd``) against ``repro.kernels.ssd.ops.ssd_intra``:
its jnp oracle (``impl="ref"``) and its Pallas kernel in interpret mode
(``impl="pallas"``), on the same numpy inputs, at
``tests/test_ssd_kernel.py``'s cases and tolerances (atol = rtol = 1e-5 in
float32, 5e-2 in bfloat16; the bf16 inputs are rounded identically on both
sides and computed in float32, so only the sum order differs), plus one
chunk at mamba2-2.7b's serving widths against the oracle.  The CUDA kernel
itself is held against this plain version on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ops as j_ops
from repro_torch import kernels
from repro_torch.kernels.ssd import ops as t_ops

CASES = [
    # (bc, q, h, p, n), as tests/test_ssd_kernel.py
    (1, 8, 1, 4, 4),
    (2, 16, 5, 8, 12),
    (3, 32, 8, 16, 16),
    (1, 64, 3, 64, 128),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def inputs(bc, q, h, p, n, seed=0):
    """x, dt, la, b, c as float32 numpy arrays, distributed as
    test_ssd_kernel.py's: dt = softplus(N(0,1)), la a decreasing cumsum."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bc, q, h, p))
    dt = np.log1p(np.exp(rng.normal(size=(bc, q, h))))
    la = np.cumsum(-np.abs(rng.normal(size=(bc, q, h))) * 0.3, axis=1)
    b = rng.normal(size=(bc, q, n))
    c = rng.normal(size=(bc, q, n))
    return [a.astype(np.float32) for a in (x, dt, la, b, c)]


def _both(arrs, jdt, tdt):
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_jax(case, dtype, impl):
    jdt, tdt, tol = DTYPES[dtype]
    jin, tin = _both(inputs(*case), jdt, tdt)
    want = np.asarray(j_ops.ssd_intra(*jin, impl=impl))
    before = dict(kernels.LAUNCHES)
    got = t_ops.ssd_intra(*tin)
    assert got.dtype == torch.float32 and got.shape == case[:4]
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)
    assert kernels.LAUNCHES == before     # the CPU path launches nothing


def test_plain_matches_jax_at_serving_widths():
    """One chunk of mamba2-2.7b's prefill: Q 256, H 80, P 64, N 128.  The
    sums run over up to 256 keys, so the bound is relative to max |y|."""
    arrs = inputs(1, 256, 80, 64, 128, seed=1)
    jin, tin = _both(arrs, jnp.float32, torch.float32)
    want = np.asarray(j_ops.ssd_intra(*jin, impl="ref"))
    got = t_ops.ssd_intra(*tin).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-5, err


def test_causal_mask_never_overflows():
    """la falls steeply, so exp(la_t - la_k) above the diagonal would be
    inf; the masked exponent keeps y equal to the oracle and its gradient
    finite (masking the result instead gives 0 * inf = nan there)."""
    x, dt, la, b, c = inputs(2, 16, 3, 4, 4, seed=2)
    la = np.cumsum(np.full_like(la, -200.0), axis=1)
    jin, tin = _both([x, dt, la, b, c], jnp.float32, torch.float32)
    tin[2].requires_grad_()
    got = t_ops.ssd_intra(*tin)
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(j_ops.ssd_intra(*jin, impl="ref")),
        atol=1e-5, rtol=1e-5)
    got.sum().backward()
    assert torch.isfinite(tin[2].grad).all()


def test_wrapper_rejects_bad_input():
    x, dt, la, b, c = (torch.from_numpy(a)
                       for a in inputs(1, 8, 2, 4, 4))
    with pytest.raises(ValueError):
        t_ops.ssd_intra(x, dt[:, :4], la, b, c)
    with pytest.raises(TypeError):
        t_ops.ssd_intra(x.double(), dt, la, b, c)
    with pytest.raises(TypeError):
        t_ops.ssd_intra(x.bfloat16(), dt, la, b, c)


def test_plain_has_a_gradient_on_the_cpu():
    """On the CPU the plain version is differentiable (the card's kernel
    has no backward and raises instead: tests/test_torch_kernels_gpu.py)."""
    x, dt, la, b, c = (torch.from_numpy(a).requires_grad_()
                       for a in inputs(1, 8, 2, 4, 4))
    t_ops.ssd_intra(x, dt, la, b, c).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (x, dt, la, b, c))
