"""Propensity-score subclassification (paper §3.2, Fig. 4) — counterpart
of :mod:`repro.core.subclassification`.

SQL: ``ntile(n) OVER (ORDER BY ps)`` then drop subclasses failing overlap.
Here: a stable sort of ps (invalid rows pushed to +inf), rank = sorted
position among valid rows, bucket = floor(rank * n / n_valid); then the
same overlap machinery as CEM over the bucket key.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.cem import CEMGroups, cem_from_keys
from repro_torch.core.keys import KeyCodec
from repro_torch.data.columnar import Table


def ntile(ps: torch.Tensor, valid: torch.Tensor, n: int) -> torch.Tensor:
    """Equal-count buckets of ps over valid rows (int64); invalid rows get
    bucket n. Ties keep row order (a stable sort, as ``lax.sort``'s)."""
    big = torch.where(valid, ps.to(torch.float32), float("inf"))
    perm = torch.sort(big, stable=True).indices
    nrows = ps.shape[0]
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(nrows, device=ps.device)
    n_valid = torch.clamp(valid.sum(), min=1)
    bucket = torch.clamp((inv * n) // n_valid, max=n - 1)
    return torch.where(valid, bucket, n)


@dataclasses.dataclass(frozen=True)
class SubclassResult:
    table: Table
    groups: CEMGroups
    ps: torch.Tensor


def subclassify(table: Table, treatment: str, outcome: str,
                ps: torch.Tensor, n_subclasses: int = 5,
                trim: Optional[Tuple[float, float]] = (0.1, 0.9)
                ) -> SubclassResult:
    """Subclassification on a given propensity score.

    ``trim`` discards units with ps outside [lo, hi] (the paper's §5.2
    "common practice" of dropping ps < 0.1 or > 0.9).
    """
    valid = table.valid
    if trim is not None:
        valid = valid & (ps >= trim[0]) & (ps <= trim[1])
    bucket = ntile(ps, valid, n_subclasses)
    codec = KeyCodec.from_cardinalities({"subclass": n_subclasses + 1})
    hi, lo = codec.pack({"subclass": bucket}, valid)
    matched_valid, row_subclass, groups = cem_from_keys(
        hi, lo, table[treatment], table[outcome], valid)
    out = Table(dict(table.columns), matched_valid).with_columns(
        {"subclass": row_subclass, "ps": ps})
    return SubclassResult(table=out, groups=groups, ps=ps)
