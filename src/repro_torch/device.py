"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card, raising if there is none: the port never
    drifts to the CPU.  An explicit ``"cpu"`` (the tests) or ``"cuda[:i]"`` is
    taken as given, and ``"cuda"`` raises without a card too."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card unless "
            "the caller passes device='cpu'")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def generator(seed: int, device=None) -> torch.Generator:
    """A generator seeded with `seed` on ``resolve_device(device)``: the
    card unless the caller asks for the CPU, raising without a card."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)
