"""Serving runtime on one device: batched prefill + state-cached decode.

Counterpart of ``repro/dist/serve.py:Server``.  The JAX Server places the
model on a ('data', 'model') mesh; here the parameters, the request batch and
the cache all live on one device, so the mesh, ``serve_view``,
``cache_specs`` and the sharding specs have no counterpart (multi-GPU
serving is ROADMAP Queue 1 item 9).  All model math lives in
``repro_torch.models``; this module only runs it, without autograd.
"""
from __future__ import annotations

import torch

from ..device import resolve_device

Tensor = torch.Tensor


class Server:
    """Inference server for one model on one device (the card unless
    `device` says otherwise; raises without a card)."""

    def __init__(self, *, model, cfg, batch_size: int, device=None):
        self.model = model
        self.cfg = cfg
        self.batch_size = batch_size
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev

    def _check(self, tokens: Tensor) -> None:
        if tokens.shape[0] != self.batch_size:
            raise ValueError(f"a batch of {tokens.shape[0]} requests; the "
                             f"server takes {self.batch_size}")
        if tokens.device != self.device:
            raise ValueError(f"tokens on {tokens.device}, server on "
                             f"{self.device}")

    def prefill(self, params: dict, batch: dict):
        """(params, {"tokens": (B, S)}) -> (last-token logits (B, vocab),
        cache)."""
        if self.cfg.family != "ssm":
            raise NotImplementedError(
                f"serving the {self.cfg.family!r} family is not ported yet "
                "(ROADMAP Queue 1 item 8)")
        self._check(batch["tokens"])
        with torch.inference_mode():
            return self.model.prefill(params, batch["tokens"], self.cfg)

    def decode(self, params: dict, token: Tensor, cache: dict, pos: Tensor):
        """(params, token (B,), cache, pos (B,)) -> (logits (B, vocab),
        the next cache)."""
        self._check(token)
        with torch.inference_mode():
            return self.model.decode_step(params, token, cache, pos, self.cfg)
