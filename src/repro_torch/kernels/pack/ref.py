"""Plain PyTorch version of the int4 nibble pack / unpack (wire format for
b <= 4) and of the mixed-width format built on it.  Counterpart of
``repro/kernels/pack/ref.py``.

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


# --------------------------------------------------- mixed bit-width wire ---
# Layerwise (per-leaf bit width) wire format: the flat level stream is a
# concatenation of per-leaf segments with static (size, bits) framing, which
# both endpoints derive from the shared LayerwiseConfig.  Segments at <= 4
# bits ride the pack4 format (packed_len bytes, the 256-level granularity
# paid per segment); wider segments stay one byte per element.


def _seg_packed(bits: int) -> bool:
    if not 1 <= int(bits) <= 8:
        raise ValueError(f"segment width must be 1..8 bits, got {bits}")
    return int(bits) <= 4


def _check_framing(sizes, bits) -> None:
    if len(sizes) != len(bits):
        raise ValueError(f"{len(sizes)} sizes but {len(bits)} widths")


def mixed_packed_len(sizes, bits) -> int:
    """Bytes on the wire for per-segment (size, bits) framing."""
    _check_framing(sizes, bits)
    return sum(packed_len(int(n)) if _seg_packed(b) else int(n)
               for n, b in zip(sizes, bits))


def pack_mixed_ref(q: Tensor, sizes, bits, pack4=pack4_ref) -> Tensor:
    """(sum(sizes),) uint8 levels, segment i's values < 2^bits[i] ->
    (mixed_packed_len(sizes, bits),) wire bytes; `pack4` packs each
    <= 4-bit segment (``ops.pack_mixed`` passes the kernel's wrapper)."""
    flat = q.reshape(-1)
    if flat.numel() != sum(int(n) for n in sizes):
        raise ValueError(f"{flat.numel()} levels for segments {sizes}")
    out, off = [], 0
    for n, b in zip(sizes, bits):
        n = int(n)
        if n:                           # an empty segment sends no bytes
            seg = flat[off:off + n]
            out.append(pack4(seg) if _seg_packed(b) else seg)
        off += n
    return torch.cat(out) if out else flat.new_zeros((0,))


def unpack_mixed_ref(packed: Tensor, sizes, bits,
                     unpack4=unpack4_ref) -> Tensor:
    """Inverse of pack_mixed_ref: wire bytes -> (sum(sizes),) levels."""
    flat = packed.reshape(-1)
    if flat.numel() != mixed_packed_len(sizes, bits):
        raise ValueError(f"{flat.numel()} wire bytes for segments {sizes} "
                         f"at {bits} bits")
    out, off = [], 0
    for n, b in zip(sizes, bits):
        n = int(n)
        m = packed_len(n) if _seg_packed(b) else n
        if n:
            seg = flat[off:off + m]
            out.append(unpack4(seg, n) if _seg_packed(b) else seg)
        off += m
    return torch.cat(out) if out else flat.new_zeros((0,))
