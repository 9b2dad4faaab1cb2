"""Architecture registry: --arch <id> -> (config, model module).

The audio family (whisper-tiny) and the ssm family (mamba2-2.7b) are ported
so far; the other architectures of ``repro/models/registry.py`` raise."""
from __future__ import annotations

import importlib
from typing import Any

from .config import ArchConfig

ARCHS = ["whisper-tiny", "mamba2-2.7b"]

_FAMILY_MODULE = {"audio": "repro_torch.models.encdec",
                  "ssm": "repro_torch.models.ssm"}


def get_config(arch: str, smoke: bool = False, **kw) -> ArchConfig:
    if arch not in ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ported: {ARCHS}; the other "
            "model families are ROADMAP Queue 1 item 8)")
    m = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    return m.smoke_config(**kw) if smoke else m.config(**kw)


def get_model(cfg: ArchConfig) -> Any:
    """The model module: init, loss_fn (and, for 'ssm', init_cache, prefill,
    decode_step)."""
    return importlib.import_module(_FAMILY_MODULE[cfg.family])
