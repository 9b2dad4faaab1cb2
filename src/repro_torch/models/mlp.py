"""The paper's DNN: 3-layer MLP (784 -> 128 -> 64 -> 10), ReLU, softmax-CE.

Counterpart of ``repro/models/mlp.py``, with the same leaf names (``w0``,
``b0``, ...) and shapes.  Every function also takes parameters stacked over
workers (leaves (N, ...)) with inputs (N, B, ...): each layer is then one
batched product (``torch.bmm``) over the N workers, and ``loss_fn`` returns
the (N,) per-worker losses.  float32 products run in full float32 when the
caller turns TF32 off (the port's launchers do).
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

LAYERS = [(784, 128), (128, 64), (64, 10)]


def init_params(gen: torch.Generator, layers=None) -> dict:
    """He-normal weights, zero biases, on the generator's device."""
    layers = layers or LAYERS
    params = {}
    for i, (fan_in, fan_out) in enumerate(layers):
        params[f"w{i}"] = torch.randn((fan_in, fan_out), generator=gen,
                                      device=gen.device) * math.sqrt(
                                          2.0 / fan_in)
        params[f"b{i}"] = torch.zeros((fan_out,), device=gen.device)
    return params


def apply(params: dict, x: Tensor) -> Tensor:
    """Logits: x (B, in) with leaves (in, out) / (out,), or x (N, B, in)
    with leaves stacked over the N workers."""
    n_layers = len([k for k in params if k.startswith("w")])
    h = x
    for i in range(n_layers):
        w, b = params[f"w{i}"], params[f"b{i}"]
        h = (torch.bmm(h, w) if w.dim() == 3 else h @ w) + b.unsqueeze(-2)
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


def loss_fn(params: dict, x: Tensor, y: Tensor) -> Tensor:
    """Mean softmax cross-entropy over the batch: a scalar, or (N,) for
    stacked parameters."""
    logp = torch.log_softmax(apply(params, x), dim=-1)
    picked = torch.take_along_dim(logp, y[..., None].long(), dim=-1)
    return -torch.mean(picked[..., 0], dim=-1)


def accuracy(params: dict, x: Tensor, y: Tensor) -> Tensor:
    return torch.mean((torch.argmax(apply(params, x), dim=-1) == y)
                      .to(torch.float32), dim=-1)


def num_params(layers=None) -> int:
    layers = layers or LAYERS
    return sum(i * o + o for i, o in layers)
