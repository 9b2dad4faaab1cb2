"""Wrappers of the nibble pack / unpack kernels (``csrc/pack.cu``).

Counterpart of ``repro/kernels/pack/pack.py:pack4``/``unpack4``.  A CUDA
tensor always goes to the kernel (or the call raises); a CPU tensor takes the
plain version in ``ref.py``.  ``pack_mixed`` / ``unpack_mixed`` (the
layerwise format, ``ref.pack_mixed_ref``) compose them: on the card each
<= 4-bit segment is one pack4 / unpack4 launch, wider segments stay one byte
per element.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .. import check_launch
from .ref import (mixed_packed_len, pack4_ref,  # noqa: F401  (re-export)
                  pack_mixed_ref, packed_len, unpack4_ref, unpack_mixed_ref)

Tensor = torch.Tensor


def _lib():
    lib = build.load("pack")
    if not getattr(lib, "_typed", False):
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        for fn in (lib.repro_pack4, lib.repro_unpack4):
            fn.argtypes = [p, p, ll, ll, ll, p]
            fn.restype = ctypes.c_int
        lib.repro_pack_error_string.argtypes = [ctypes.c_int]
        lib.repro_pack_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(x: Tensor, name: str) -> None:
    if x.dtype != torch.uint8:
        raise TypeError(f"{name} must be uint8, got {x.dtype}")
    if x.dim() not in (1, 2):
        raise ValueError(f"{name} must be 1-D or 2-D, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.dim() == 2 and x.shape[0] > 65535:
        raise ValueError(f"at most 65535 rows, got {x.shape[0]}")


def pack4(q: Tensor) -> Tensor:
    """(n,) or (rows, n) uint8 levels < 16 -> (..., packed_len(n)) bytes."""
    _check(q, "q")
    if q.device.type == "cpu":
        return pack4_ref(q)
    n = q.shape[-1]
    plen = packed_len(n)
    rows = q.shape[0] if q.dim() == 2 else 1
    out = torch.empty((*q.shape[:-1], plen), dtype=torch.uint8, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    rc = lib.repro_pack4(q.data_ptr(), out.data_ptr(), rows, n, plen,
                         torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(lib, "repro_pack_error_string", rc, "pack4")
    return out


def unpack4(packed: Tensor, n: int) -> Tensor:
    """(plen,) or (rows, plen) packed bytes -> (..., n) uint8 levels, with
    plen == packed_len(n)."""
    _check(packed, "packed")
    if packed.device.type == "cpu":
        return unpack4_ref(packed, n)
    plen = packed_len(n)
    if packed.shape[-1] != plen:
        raise ValueError(f"packed rows of {packed.shape[-1]} bytes do not hold "
                         f"{n} levels (need {plen})")
    rows = packed.shape[0] if packed.dim() == 2 else 1
    out = torch.empty((*packed.shape[:-1], n), dtype=torch.uint8,
                      device=packed.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    rc = lib.repro_unpack4(packed.data_ptr(), out.data_ptr(), rows, n, plen,
                           torch.cuda.current_stream(packed.device).cuda_stream)
    check_launch(lib, "repro_pack_error_string", rc, "unpack4")
    return out


def pack_mixed(q: Tensor, sizes, bits) -> Tensor:
    """Per-segment (size, bits) mixed-width packing of a flat uint8 level
    stream; each <= 4-bit segment goes through ``pack4`` (one launch on the
    card).  ``ref.pack_mixed_ref`` is the format and the bitwise oracle."""
    return pack_mixed_ref(q, sizes, bits, pack4=pack4)


def unpack_mixed(packed: Tensor, sizes, bits) -> Tensor:
    """Inverse of pack_mixed (same static framing), through ``unpack4``."""
    return unpack_mixed_ref(packed, sizes, bits, unpack4=unpack4)
