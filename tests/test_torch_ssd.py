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


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: round the 13 low bits of the float32
    pattern on its magnitude and clear them."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(a: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 by clearing the 13 low bits (toward zero)."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b in float32 from TF32 parts: 1 pass hi.hi; 3 passes (the CUDA
    kernel's 3xTF32) lo.hi + hi.lo + hi.hi, with hi = tf32_rna(a) and lo =
    a - hi truncated to TF32, as the kernel splits.  The part products are
    exact in float32; the sums are float32."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    out = ah @ bh
    if passes == 3:
        al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
        out = al @ bh + ah @ bl + out
    return out


def ssd_intra_tf32(x, dt, la, b, c, passes):
    """The plain version's steps with both products taken from TF32 parts,
    as the CUDA kernel takes them on the tensor cores (one chunk row)."""
    f32 = torch.float32
    x, dt, la, b, c = (t.to(f32) for t in (x, dt, la, b, c))
    q = x.shape[1]
    cb = tf32_matmul(c[0], b[0].T, passes)                     # (Q, Q)
    tri = torch.ones((q, q), dtype=torch.bool).tril()
    seg = la[0][:, None, :] - la[0][None, :, :]                # (Q, K, H)
    decay = torch.exp(torch.where(tri[:, :, None], seg, float("-inf")))
    w = cb[..., None] * decay * dt[0][None, :, :]              # (Q, K, H)
    y = tf32_matmul(w.permute(2, 0, 1), x[0].permute(1, 0, 2), passes)
    return y.permute(1, 0, 2)[None]                            # (1, Q, H, P)


@pytest.mark.parametrize("dtype,passes,under_gate", [
    (torch.float32, 3, True),       # the kernel's route for float32
    (torch.bfloat16, 3, True),      # bf16: the lo parts of x, b, c are 0
    (torch.float32, 1, False),      # TF32 alone would fail the gate
])
def test_tf32_split_holds_the_gate_at_serving_widths(dtype, passes,
                                                     under_gate):
    """The CUDA kernel's precision design, checked on the CPU: 3xTF32 on one
    chunk row of mamba2-2.7b's serving widths (Q 256, H 80, P 64, N 128)
    stays within the card's gate of 1e-5 x max |plain| (it gives about
    5e-7); 1xTF32 is far outside it."""
    tin = [torch.from_numpy(a).to(dtype)
           for a in inputs(1, 256, 80, 64, 128, seed=1)]
    plain = t_ops.ssd_intra_ref(*tin)
    got = ssd_intra_tf32(*tin, passes=passes)
    rel = float((got - plain).abs().max() / plain.abs().max())
    if under_gate:
        assert rel < 1e-5 / 4, rel
    else:
        assert rel > 1e-5, rel
    if dtype == torch.bfloat16:     # bf16 is exact in TF32: no lo parts
        for t in tin:
            assert torch.equal(tf32_rna(t.float()), t.float())


def test_tf32_rna_rounds_ties_away():
    one = 1.0 + 2.0 ** -10                      # a TF32 value
    half_ulp = 2.0 ** -11
    a = torch.tensor([1.0, one, 1.0 + half_ulp, -(1.0 + half_ulp),
                      1.0 + half_ulp * 0.99, 2.0 - 2.0 ** -12],
                     dtype=torch.float32)
    want = torch.tensor([1.0, one, one, -one, 1.0, 2.0],  # last: carries
                        dtype=torch.float32)
    assert torch.equal(tf32_rna(a), want)
    assert torch.equal(tf32_rna(tf32_rna(a)), tf32_rna(a))
    assert torch.equal(tf32_trunc(a), torch.tensor(
        [1.0, one, 1.0, -1.0, 1.0, 2.0 - 2.0 ** -10], dtype=torch.float32))
