"""Parameter-server baselines of the paper's evaluation: GD, QGD, ADIANA.

Counterpart of ``repro/core/baselines.py``.  All solve
min_theta sum_n f_n(theta), f_n quadratic (linear regression), with N
workers uploading (possibly quantized) gradients to a PS each round and the
PS broadcasting the model back.

Communication per iteration (paper Sec. V-A):
  GD:     N uploads of 32 d bits            + PS download 32 d
  QGD:    N uploads of (b d + 32) bits      + PS download 32 d
  ADIANA: N uploads of 2 quantized vectors (32 + 2 b d) + PS download 32 d

A quantized iteration is one launch of the codec (K1) over the N workers'
rows, each with its own radius, from a zero previous hat.  The loops take
the per-iteration (N, d) draws when given, else draw them from a generator
seeded with `seed` on the problem's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import generator
from ..kernels.quantize import ops as q_ops
from .quantizer import require_f32

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PSProblem:
    xtx: Tensor   # (N, d, d)
    xty: Tensor   # (N, d)

    def __post_init__(self):
        require_f32(self.xtx, self.xty)

    @property
    def n(self) -> int:
        return self.xtx.shape[0]

    @property
    def d(self) -> int:
        return self.xtx.shape[-1]

    def grad(self, theta: Tensor) -> Tensor:
        """Per-worker gradients, (N, d)."""
        return torch.einsum("nde,e->nd", self.xtx, theta) - self.xty

    def objective(self, theta: Tensor) -> Tensor:
        quad = 0.5 * torch.einsum("d,nde,e->", theta, self.xtx, theta)
        return quad - torch.einsum("nd,d->", self.xty, theta)

    def lipschitz(self) -> float:
        return float(torch.linalg.eigvalsh(torch.sum(self.xtx, dim=0))[-1])

    def strong_convexity(self) -> float:
        return float(torch.linalg.eigvalsh(torch.sum(self.xtx, dim=0))[0])


def _stoch_quantize(g: Tensor, u: Tensor, bits: int) -> Tensor:
    """Unbiased stochastic quantization of each row of g (range = the row's
    inf norm): the codec with a zero previous hat, so step * q - R as in
    the JAX function (0 + x is exact), and 0 where R == 0 (the row is then
    all zeros)."""
    require_f32(g)
    r = torch.amax(torch.abs(g), dim=1)
    _, out = q_ops.quantize_dequantize(g, torch.zeros_like(g), u, r,
                                       2.0 ** bits - 1.0)
    return out


def _draw(u, k: int, gen, shape, device) -> Tensor:
    if u is not None:
        return torch.as_tensor(u[k], dtype=torch.float32, device=device)
    return torch.rand(shape, generator=gen, device=device)


def run_gd(problem: PSProblem, iters: int, lr: float | None = None,
           quantize_bits: int | None = None, seed: int = 0, u=None):
    """(Q)GD: returns (thetas (iters, d), bits_per_iter).  u: optional
    (iters, N, d) draws of the quantized variant."""
    lr = lr if lr is not None else 1.0 / problem.lipschitz()
    n, d, dev = problem.n, problem.d, problem.xtx.device
    gen = generator(seed, dev) if quantize_bits is not None and u is None \
        else None
    theta = torch.zeros((d,), dtype=torch.float32, device=dev)
    thetas = []
    for k in range(iters):
        g = problem.grad(theta)
        if quantize_bits is not None:
            g = _stoch_quantize(g, _draw(u, k, gen, (n, d), dev),
                                quantize_bits)
        theta = theta - lr * torch.sum(g, dim=0)
        thetas.append(theta)
    up = 32 * d if quantize_bits is None else quantize_bits * d + 32
    return torch.stack(thetas), n * up + 32 * d


def run_adiana(problem: PSProblem, iters: int, bits: int = 2, seed: int = 0,
               u=None):
    """Accelerated DIANA [Li et al. 2020] on quantized gradient differences,
    with the JAX function's parameters (strongly convex setting, omega =
    min(d / s^2, sqrt(d) / s), s = 2^b - 1).  Returns (ys (iters, d),
    bits_per_iter).  u: optional (iters, N, d) draws."""
    n, d, dev = problem.n, problem.d, problem.xtx.device
    L = problem.lipschitz()
    mu = max(problem.strong_convexity(), 1e-12)
    s = 2.0**bits - 1.0
    # the square roots in float32, as the JAX function takes them
    omega = min(d / s**2, float(np.sqrt(np.float32(d))) / s)
    alpha = 1.0 / (1.0 + omega)
    eta = 1.0 / (2.0 * L * (1.0 + omega))
    tau = min(0.5, float(np.sqrt(np.float32(eta * mu))))
    gamma = eta / (2.0 * (tau + eta * mu))
    gen = generator(seed, dev) if u is None else None
    y = torch.zeros((d,), dtype=torch.float32, device=dev)
    z = y
    h = torch.zeros((n, d), dtype=torch.float32, device=dev)
    ys = []
    for k in range(iters):
        x = tau * z + (1.0 - tau) * y
        g_local = problem.grad(x)
        delta = _stoch_quantize(g_local - h, _draw(u, k, gen, (n, d), dev),
                                bits)
        g = torch.sum(h + delta, dim=0)
        h = h + alpha * delta
        y = x - eta * g
        z = (z + gamma * mu * x - gamma * g) / (1.0 + gamma * mu)
        ys.append(y)
    return torch.stack(ys), n * (32 + 2 * bits * d) + 32 * d
