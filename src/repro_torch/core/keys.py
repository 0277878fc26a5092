"""Bit-packed group keys — counterpart of :mod:`repro.core.keys`.

A key is two u32 words (hi, lo), MSB-first over the codec's fields; the
invalid marker is ``0xFFFFFFFF`` in both words. The port holds each word
in an int64 tensor with ``& 0xFFFFFFFF`` masks: torch has no unsigned
32-bit arithmetic, and ``>>`` on int32 is arithmetic (it would smear the
sign bit of the marker).

Where ONE sortable key is needed (sort, binary search) the two words
combine as :func:`sort_key`, ``((hi ^ 0x80000000) << 32) | lo`` read as a
signed int64: without the sign flip the marker (-1 as int64) would sort
FIRST instead of last.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Sequence, Tuple

import torch

MASK32 = 0xFFFFFFFF
INVALID_HI = 0xFFFFFFFF
INVALID_LO = 0xFFFFFFFF
_MAX_BITS = 63  # valid keys can never collide with the invalid marker


def _width(cardinality: int) -> int:
    return max(1, math.ceil(math.log2(max(2, cardinality))))


def sort_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 image of the (hi, lo) u32 pair:
    ``(hi - 2^31) * 2^32 + lo`` — the same bits as
    ``((hi ^ 0x80000000) << 32) | lo``, computed without an int64
    overflow. Lexicographic u32 order becomes signed int64 order, and the
    invalid marker maps to the int64 maximum, so it sorts last."""
    return (hi - (1 << 31)) * (1 << 32) + lo


@dataclasses.dataclass(frozen=True)
class KeyCodec:
    """Packs named fields (each with a static cardinality) into (hi, lo)."""

    fields: Tuple[Tuple[str, int], ...]  # (name, cardinality), MSB-first

    def __post_init__(self):
        if self.total_bits > _MAX_BITS:
            raise ValueError(
                f"key needs {self.total_bits} bits > {_MAX_BITS}; coarsen more "
                f"aggressively or split the GROUP BY: {self.fields}")

    @staticmethod
    def from_cardinalities(cards: Mapping[str, int]) -> "KeyCodec":
        return KeyCodec(tuple((n, int(c)) for n, c in sorted(cards.items())))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.fields)

    @property
    def widths(self) -> Dict[str, int]:
        return {n: _width(c) for n, c in self.fields}

    @property
    def total_bits(self) -> int:
        return sum(self.widths.values())

    def offsets(self) -> Dict[str, int]:
        """Bit offset (from LSB of the 64-bit key) of each field."""
        offs, pos = {}, self.total_bits
        for n, _ in self.fields:
            pos -= self.widths[n]
            offs[n] = pos
        return offs

    # -- packing ---------------------------------------------------------
    def pack(self, buckets: Mapping[str, torch.Tensor], valid: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """buckets[name] integer ids in [0, card) -> (hi, lo) int64 words
        holding u32 values. Invalid rows get the all-ones marker."""
        hi = torch.zeros(valid.shape, dtype=torch.int64, device=valid.device)
        lo = torch.zeros_like(hi)
        for name, _ in self.fields:
            w = self.widths[name]
            v = buckets[name].to(torch.int64) & MASK32
            # (hi, lo) <<= w ; lo |= v      (w in [1, 31]), mod 2^32
            hi = ((hi << w) | (lo >> (32 - w))) & MASK32
            lo = ((lo << w) | v) & MASK32
        hi = torch.where(valid, hi, INVALID_HI)
        lo = torch.where(valid, lo, INVALID_LO)
        return hi, lo

    # -- field extraction / rollup ----------------------------------------
    def extract(self, hi: torch.Tensor, lo: torch.Tensor, name: str
                ) -> torch.Tensor:
        """Recover one field's bucket ids (int64) from packed keys."""
        off = self.offsets()[name]
        w = self.widths[name]
        mask = (1 << w) - 1
        if off >= 32:
            return (hi >> (off - 32)) & mask
        if off + w <= 32:
            return (lo >> off) & mask
        lo_bits = 32 - off
        lo_part = lo >> off
        hi_part = (hi & ((1 << (w - lo_bits)) - 1)) << lo_bits
        return (hi_part | lo_part) & mask

    def subcodec(self, names: Sequence[str]) -> "KeyCodec":
        keep = set(names)
        return KeyCodec(tuple((n, c) for n, c in self.fields if n in keep))

    def rollup(self, hi: torch.Tensor, lo: torch.Tensor,
               names: Sequence[str], valid: torch.Tensor
               ) -> Tuple["KeyCodec", torch.Tensor, torch.Tensor]:
        """Re-key onto a subset of fields (cube rollup). Returns sub-codec +
        packed sub-keys."""
        sub = self.subcodec(names)
        buckets = {n: self.extract(hi, lo, n) for n in sub.names}
        shi, slo = sub.pack(buckets, valid)
        return sub, shi, slo
