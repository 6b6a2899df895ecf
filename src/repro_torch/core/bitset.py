"""Bit-packed boolean matrices (the adjacency representation), in torch.

Port of `repro.core.bitset`.  Bits pack LSB-first into 32-bit words: column
``j`` lives in word ``j >> 5``, bit ``j & 31``.  Words are stored as
``torch.int32`` carrying the reference's ``uint32`` bit pattern, because
torch on the CPU has no right shift on ``uint32``.  Two rules follow:

* every right shift is followed by ``& 1`` (or a mask), since int32 ``>>``
  is arithmetic and drags bit 31 down;
* bit 31's mask is ``INT32_MIN``; masks are built in int64 and wrapped to
  int32 (`to_int32`), never by shifting a signed 1 into the sign bit.

At the numpy boundary convert with ``.view(np.uint32)`` / ``.view(np.int32)``.
All functions are out of place; capacities must be multiples of 32.
"""
from __future__ import annotations

import torch

WORD = 32


def n_words(capacity: int) -> int:
    if capacity % WORD != 0:
        raise ValueError(f"capacity must be a multiple of {WORD}, got {capacity}")
    return capacity // WORD


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def bit_masks(shift: torch.Tensor) -> torch.Tensor:
    """int32 single-bit masks ``1 << shift`` for shift in [0, 32)."""
    return to_int32(torch.ones_like(shift, dtype=torch.int64)
                    << shift.to(torch.int64))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[..., C] -> int32[..., C/32] (little-endian bit order in a word)."""
    *lead, c = bits.shape
    w = n_words(c)
    grouped = bits.reshape(*lead, w, WORD).to(torch.int32)
    out = torch.zeros((*lead, w), dtype=torch.int32, device=bits.device)
    for k in range(WORD):
        # bit 31's mask is INT32_MIN; a 0/1 multiply keeps it exact
        out |= grouped[..., k] * (-(1 << 31) if k == 31 else (1 << k))
    return out


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """int32[..., W] -> bool[..., W*32]."""
    *lead, w = packed.shape
    shifts = torch.arange(WORD, dtype=torch.int32, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.to(torch.bool).reshape(*lead, w * WORD)


def bit_get(packed: torch.Tensor, rows: torch.Tensor,
            cols: torch.Tensor) -> torch.Tensor:
    """Read bits at (rows[b], cols[b]) from packed[C, W] -> bool[B]."""
    word = cols >> 5
    shift = cols & 31
    return ((packed[rows, word] >> shift) & 1).to(torch.bool)


def onehot_rows(slots: torch.Tensor, capacity: int) -> torch.Tensor:
    """slots int32[B] -> packed one-hot int32[B, W]."""
    w = n_words(capacity)
    b = slots.shape[0]
    base = torch.zeros((b, w), dtype=torch.int32, device=slots.device)
    base[torch.arange(b, device=slots.device), (slots >> 5).long()] = \
        bit_masks(slots & 31)
    return base


def _stable_argsort(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def _first_sorted_scatter(order: torch.Tensor,
                          first_sorted: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(first_sorted)
    out[order] = first_sorted
    return out


def _first_occurrence(key: torch.Tensor) -> torch.Tensor:
    """bool[B]: True at the first occurrence (lowest batch index) of each
    distinct key value — which needs the stable sort."""
    order = _stable_argsort(key)
    sk = key[order]
    first_sorted = torch.cat([torch.ones(1, dtype=torch.bool,
                                         device=key.device),
                              sk[1:] != sk[:-1]])
    return _first_sorted_scatter(order, first_sorted)


def _dedupe_enabled(rows: torch.Tensor, cols: torch.Tensor,
                    enable: torch.Tensor, capacity: int) -> torch.Tensor:
    """First-occurrence mask over enabled (row, col) pairs.

    Sorts lexicographically on (enable, row, col) — successive stable
    sorts, least significant key first — rather than on the composed key
    ``row * capacity + col``, which overflows int32 once capacity reaches
    2^16.  Disabled entries sort into their own group with unique
    per-index keys, so they never suppress an enabled duplicate."""
    del capacity
    b = rows.shape[0]
    idx = torch.arange(b, dtype=rows.dtype, device=rows.device)
    en = enable.to(rows.dtype)
    k_row = torch.where(enable, rows, idx)
    k_col = torch.where(enable, cols, torch.zeros_like(cols))
    order = _stable_argsort(k_col)
    order = order[_stable_argsort(k_row[order])]
    order = order[_stable_argsort(en[order])]
    sk_e, sk_r, sk_c = en[order], k_row[order], k_col[order]
    first_sorted = torch.cat([
        torch.ones(1, dtype=torch.bool, device=rows.device),
        (sk_e[1:] != sk_e[:-1]) | (sk_r[1:] != sk_r[:-1])
        | (sk_c[1:] != sk_c[:-1])])
    return _first_sorted_scatter(order, first_sorted)


def _scattered_masks(shape, rows: torch.Tensor, word: torch.Tensor,
                     mask: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """int32[shape] holding the bits ``mask[b]`` at (rows[b], word[b]) for
    the enabled entries.  The enabled bits are pairwise distinct, so the
    accumulating add is an OR and never carries."""
    out = torch.zeros(shape, dtype=torch.int32, device=rows.device)
    out.index_put_((rows[do].long(), word[do].long()), mask[do],
                   accumulate=True)
    return out


def scatter_set_bits(packed: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor, enable: torch.Tensor) -> torch.Tensor:
    """Set bits (rows[b], cols[b]) where enable[b]; duplicate-safe."""
    capacity = packed.shape[0]
    word = cols >> 5
    shift = cols & 31
    existing = (packed[rows, word] >> shift) & 1
    first = _dedupe_enabled(rows, cols, enable, capacity)
    do = enable & first & (existing == 0)
    return packed | _scattered_masks(packed.shape, rows, word,
                                     bit_masks(shift), do)


def scatter_clear_bits(packed: torch.Tensor, rows: torch.Tensor,
                       cols: torch.Tensor, enable: torch.Tensor) -> torch.Tensor:
    """Clear bits (rows[b], cols[b]) where enable[b]; duplicate-safe."""
    capacity = packed.shape[0]
    word = cols >> 5
    shift = cols & 31
    existing = (packed[rows, word] >> shift) & 1
    first = _dedupe_enabled(rows, cols, enable, capacity)
    do = enable & first & (existing == 1)
    return packed & ~_scattered_masks(packed.shape, rows, word,
                                      bit_masks(shift), do)


def popcount(packed: torch.Tensor) -> torch.Tensor:
    """Number of set bits, summed over the last axis (int32)."""
    return popcount_swar(packed)


def popcount_swar(packed: torch.Tensor) -> torch.Tensor:
    """SWAR popcount, computed on the words widened to int64 so the
    subtractions and the final multiply cannot overflow a signed type."""
    x = packed.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return torch.sum(x, dim=-1, dtype=torch.int32)
