"""PyTorch / CUDA port of the Q-GADMM reproduction, for one NVIDIA H100.

``repro_torch`` mirrors the layout of the JAX package ``repro``, which stays
the reference it is tested against; it imports neither ``jax`` nor anything
of ``repro``.  Plain tensor code is PyTorch; every kernel that ``repro``
writes in Pallas for the TPU is a hand-written CUDA kernel here
(``repro_torch/csrc``), built at first use by ``repro_torch.kernels.build``,
with a plain PyTorch version beside it that the CPU takes.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise (``resolve_device``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
