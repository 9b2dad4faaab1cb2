"""Plain PyTorch version of the fused stochastic quantize-dequantize.

Counterpart of ``repro/kernels/quantize/ref.py``.  Every operation is its own
rounded f32 operation (PyTorch runs them eagerly, one kernel each, never
contracted into an FMA), in the order of the CUDA kernel's intrinsics, so the
plain version and ``csrc/quantize.cu`` agree bitwise.  The trainer's receivers
decode with the same arithmetic (``decode_ref``).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def step_size(radius: Tensor, levels: Tensor) -> Tensor:
    """2 * max(R, 1e-30) / levels, in f32 on R's device."""
    return (2.0 * torch.clamp_min(radius, 1e-30)) / levels


def quantize_dequantize_ref(theta: Tensor, theta_hat_prev: Tensor, u: Tensor,
                            radius: Tensor, levels: Tensor
                            ) -> tuple[Tensor, Tensor]:
    """(q uint8, new hat in theta_hat_prev's dtype).

    theta, theta_hat_prev, u: same shape (u f32 uniform in [0, 1)).
    radius, levels: f32, broadcastable against theta (a scalar, a per-row
    column, or one value per element).  Where R == 0, q = 0 and the hat is
    unchanged."""
    x = theta.to(torch.float32)
    h = theta_hat_prev.to(torch.float32)
    step = step_size(radius, levels)
    c = ((x - h) + radius) / step
    low = torch.floor(c)
    p = c - low
    q = low + (u < p).to(torch.float32)
    q = torch.minimum(torch.clamp_min(q, 0.0), levels)
    hat = (h + step * q) - radius
    active = radius > 0
    q = torch.where(active, q, torch.zeros_like(q))
    hat = torch.where(active, hat, h)
    return q.to(torch.uint8), hat.to(theta_hat_prev.dtype)


def decode_ref(hat_prev: Tensor, q: Tensor, radius: Tensor, levels: Tensor
               ) -> Tensor:
    """Receiver-side reconstruction of the codec's hat from the wire levels:
    the same f32 operations as the sender's hat, so both agree bitwise.
    radius/levels broadcast against hat_prev; returns hat_prev's dtype."""
    h = hat_prev.to(torch.float32)
    step = step_size(radius, levels)
    out = (h + step * q.to(torch.float32)) - radius
    return torch.where(radius > 0, out, h).to(hat_prev.dtype)
