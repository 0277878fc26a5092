"""Coarsened Exact Matching (paper §3.2) — the parts the online engine
uses, counterpart of :mod:`repro.core.cem`.

A CEM group is *retained* iff it holds at least one treated and one
control valid unit (the overlap filter ``max(T) != min(T)``).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from repro_torch.core import groupby
from repro_torch.core.coarsen import CoarsenSpec
from repro_torch.core.keys import KeyCodec


@dataclasses.dataclass(frozen=True)
class CEMGroups:
    """Per-group CEM statistics (tensors padded to the group table).

    Group g is *retained* iff keep[g]: a real key group with overlap.
    """

    grouping: groupby.Grouping
    keep: torch.Tensor        # (N,) bool per group id
    n_treated: torch.Tensor   # (N,) f32 per group
    n_control: torch.Tensor   # (N,) f32
    sum_y_t: torch.Tensor     # (N,) f32  sum of outcome over treated
    sum_y_c: torch.Tensor     # (N,) f32


def overlap_keep(group_valid: torch.Tensor, n_treated: torch.Tensor,
                 n_control: torch.Tensor) -> torch.Tensor:
    """A group is matched iff it has >=1 treated and >=1 control unit."""
    return group_valid & (n_treated > 0) & (n_control > 0)


def update_overlap(keep: torch.Tensor, group_valid: torch.Tensor,
                   n_treated: torch.Tensor, n_control: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """Incremental CEM, IN PLACE on ``keep``: re-evaluate overlap only at
    ``positions`` (the group ids a delta touched); ``n_treated`` and
    ``n_control`` are given AT those positions. Duplicate positions write
    the same value. Returns ``keep``."""
    keep[positions] = (group_valid[positions] & (n_treated > 0)
                       & (n_control > 0))
    return keep


def make_codec(specs: Mapping[str, CoarsenSpec]) -> KeyCodec:
    return KeyCodec.from_cardinalities(
        {name: spec.n_buckets for name, spec in specs.items()})
