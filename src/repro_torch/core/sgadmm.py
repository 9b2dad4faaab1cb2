"""SGADMM and Q-SGADMM: the stochastic, non-convex variant (paper Sec. V-B).

Counterpart of ``repro/core/sgadmm.py``.  Against the convex Algorithm 1:
each worker's local argmin becomes ``local_iters`` Adam steps on its
stochastic augmented Lagrangian (eq. 14/16),

    f + lam_l . (hat_l - theta) + lam_r . (theta - hat_r)
      + rho/2 (||hat_l - theta||^2 + ||theta - hat_r||^2),

and the dual step is damped, lam += alpha * rho * (hat_n - hat_{n+1})
(eq. 18; alpha = 0.01 in the paper).  The chain state is held as flat
(N, d) float32 buffers in the JAX leaf order (``ravel_pytree``'s), and the
N workers' local problems run at once: one batched forward per Adam step
(``loss_fn`` takes parameters stacked over workers), one autograd pass over
the sum of the N losses (rows do not interact, so each row gets its own
gradient).  All rows step; only the active rows commit.  Each phase is one
codec launch (K1) over the N rows.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..device import generator, resolve_device
from ..tree import ParamLayout, leaves_with_path
from .gadmm import (GADMMConfig, _chain_dual_update, _draws, _quantize_rows,
                    bits_per_round)
from .quantizer import require_f32

Tensor = torch.Tensor

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class SGADMMConfig:
    gadmm: GADMMConfig
    local_iters: int = 10
    local_lr: float = 1e-3
    batch_size: int = 100


class SGADMMState(NamedTuple):
    theta: Tensor      # (N, d)
    theta_hat: Tensor  # (N, d)
    lam: Tensor        # (N+1, d)
    radius: Tensor     # (N,)
    bits: Tensor       # (N,) int32
    adam_mu: Tensor    # (N, d)
    adam_nu: Tensor    # (N, d)
    adam_t: Tensor     # (N,) int32
    gen: torch.Generator
    step: int


class SGADMMTrainer:
    """Decentralized trainer of a parameter tree over a worker chain.

    loss_fn(params, x, y): with leaves stacked over the N workers and x / y
    of shape (N, B, ...), the (N,) per-worker losses (``models.mlp.loss_fn``
    is one).  params0: the initial tree, copied to every worker, on the
    device the trainer runs on (the card unless ``device='cpu'``)."""

    def __init__(self, loss_fn: Callable, params0, n_workers: int,
                 cfg: SGADMMConfig, seed: int = 0, device=None):
        dev = resolve_device(device)
        require_f32(*(x for _, x in leaves_with_path(params0)))
        self.layout = ParamLayout.of(params0)
        flat0 = self.layout.flatten(params0).to(dev)
        self.d = flat0.numel()
        self.n = n_workers
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.device = dev
        n, d = n_workers, self.d
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        self.state = SGADMMState(
            theta=flat0[None].repeat(n, 1), theta_hat=z(n, d),
            lam=z(n + 1, d), radius=z(n),
            bits=torch.full((n,), cfg.gadmm.qcfg.bits, dtype=torch.int32,
                            device=dev),
            adam_mu=z(n, d), adam_nu=z(n, d),
            adam_t=torch.zeros((n,), dtype=torch.int32, device=dev),
            gen=generator(seed, dev), step=0)
        idx = torch.arange(n, device=dev)
        self._is_head = (idx % 2) == 0
        self._has_l = (idx > 0).to(torch.float32)
        self._has_r = (idx < n - 1).to(torch.float32)

    def _local_losses(self, flat, x, y, lam_l, lam_r, hat_l, hat_r):
        """(N,) augmented Lagrangians seen by the workers (eq. 14/16 with
        stochastic f); the missing neighbours' rows of lam are zero."""
        rho = self.cfg.gadmm.rho
        f = self.loss_fn(self.layout.views(flat), x, y)
        dual = (torch.sum(lam_l * (hat_l - flat), dim=1)
                + torch.sum(lam_r * (flat - hat_r), dim=1))
        prox = 0.5 * rho * (self._has_l * torch.sum((hat_l - flat) ** 2, dim=1)
                            + self._has_r * torch.sum((flat - hat_r) ** 2,
                                                      dim=1))
        return f + dual + prox

    def _local_adam(self, theta, mu, nu, t, x, y, lam_l, lam_r, hat_l,
                    hat_r):
        lr = self.cfg.local_lr
        b1 = torch.tensor(B1, dtype=torch.float32, device=self.device)
        b2 = torch.tensor(B2, dtype=torch.float32, device=self.device)
        for _ in range(self.cfg.local_iters):
            with torch.enable_grad():
                th = theta.detach().requires_grad_(True)
                loss = self._local_losses(th, x, y, lam_l, lam_r, hat_l,
                                          hat_r).sum()
                (g,) = torch.autograd.grad(loss, th)
            t = t + 1
            mu = B1 * mu + (1 - B1) * g
            nu = B2 * nu + (1 - B2) * g * g
            tf = t.to(torch.float32)[:, None]
            mhat = mu / (1 - torch.pow(b1, tf))     # float32, as the JAX
            vhat = nu / (1 - torch.pow(b2, tf))     # function's b1 ** t
            theta = theta - lr * mhat / (torch.sqrt(vhat) + EPS)
        return theta, mu, nu, t

    def _phase(self, st: tuple, xb, yb, active: Tensor, u) -> tuple:
        theta, hat, lam, radius, bits, mu, nu, t = st
        hat_l = torch.roll(hat, 1, dims=0) * self._has_l[:, None]
        hat_r = torch.roll(hat, -1, dims=0) * self._has_r[:, None]
        new_theta, new_mu, new_nu, new_t = self._local_adam(
            theta, mu, nu, t, xb, yb, lam[:-1], lam[1:], hat_l, hat_r)
        m = active[:, None]
        theta = torch.where(m, new_theta, theta)
        mu = torch.where(m, new_mu, mu)
        nu = torch.where(m, new_nu, nu)
        t = torch.where(active, new_t, t)
        hat, radius, bits = _quantize_rows(theta, hat, active, u, radius,
                                           bits, self.cfg.gadmm)
        return theta, hat, lam, radius, bits, mu, nu, t

    def train_step(self, xb: Tensor, yb: Tensor, u=None) -> None:
        """xb: (N, batch, dim), yb: (N, batch) minibatch per worker, on the
        trainer's device; u: optional pair of (N, d) draws for the two
        phases (else drawn from the state's generator)."""
        s = self.state
        u_h, u_t = _draws(s.gen, s.theta.shape, u, self.cfg.gadmm,
                          self.device)
        st = (s.theta, s.theta_hat, s.lam, s.radius, s.bits, s.adam_mu,
              s.adam_nu, s.adam_t)
        st = self._phase(st, xb, yb, self._is_head, u_h)
        st = self._phase(st, xb, yb, ~self._is_head, u_t)
        theta, hat, lam, radius, bits, mu, nu, t = st
        self.state = SGADMMState(
            theta=theta, theta_hat=hat,
            lam=_chain_dual_update(lam, hat, self.cfg.gadmm), radius=radius,
            bits=bits, adam_mu=mu, adam_nu=nu, adam_t=t, gen=s.gen,
            step=s.step + 1)

    def worker_params(self, n: int) -> dict:
        return self.layout.views(self.state.theta[n].clone())

    def mean_params(self) -> dict:
        return self.layout.views(torch.mean(self.state.theta, dim=0))

    def bits_per_round(self) -> int:
        return bits_per_round(self.cfg.gadmm, self.n, self.d)
