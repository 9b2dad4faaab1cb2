"""Plain PyTorch version of the int4 nibble pack / unpack (wire format for
b <= 4).  Counterpart of ``repro/kernels/pack/ref.py`` (pack4/unpack4 only).

Wire format: a row of n uint8 levels is zero-padded to a whole number of
(2*128)-level groups and viewed as (groups, 2, 128); byte r*128 + c packs
lo = level[r*256 + c] and hi = level[r*256 + 128 + c].  A packed row is
``packed_len(n) = 128 * ceil(n / 256)`` bytes.  Both functions take one row
(1-D) or a batch of rows (2-D), each row laid out as the single-row format.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

LANES = 128


def _pad_rows(n: int) -> int:
    return -(-n // (2 * LANES))


def packed_len(n: int) -> int:
    """Bytes on the wire for n packed levels: 128 * ceil(n / 256).  The
    single source of the pack4 wire length for sender, receivers and the
    trainer's bit accounting."""
    return LANES * _pad_rows(n)


def pack4_ref(q: Tensor) -> Tensor:
    """(..., n) uint8 levels (< 16) -> (..., packed_len(n)) packed bytes."""
    n = q.shape[-1]
    m = _pad_rows(n)
    flat = q.reshape(-1, n)
    pad = m * 2 * LANES - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros((flat.shape[0], pad))], dim=1)
    q4 = flat.reshape(-1, m, 2, LANES)
    out = q4[:, :, 0, :] | (q4[:, :, 1, :] << 4)
    return out.reshape(*q.shape[:-1], m * LANES)


def unpack4_ref(packed: Tensor, n: int) -> Tensor:
    """(..., packed_len(n)) packed bytes -> (..., n) uint8 levels."""
    m = _pad_rows(n)
    if packed.shape[-1] != m * LANES:
        raise ValueError(f"packed rows of {packed.shape[-1]} bytes do not hold "
                         f"{n} levels (need {m * LANES})")
    p = packed.reshape(-1, m, LANES)
    lo = p & 0xF
    hi = p >> 4
    out = torch.stack([lo, hi], dim=2).reshape(-1, m * 2 * LANES)[:, :n]
    return out.reshape(*packed.shape[:-1], n).contiguous()
