"""Coarsened Exact Matching (paper §3.2, Fig. 5) — counterpart of
:mod:`repro.core.cem`.

CEM = coarsen covariates -> GROUP BY coarsened vector -> keep only groups
containing at least one treated and one control valid unit (the overlap
filter ``max(T) != min(T)``). The matched "subclass" id is the group id.
:func:`cem_from_keys` consumes packed keys (the engine's and
subclassification's core); :func:`cem` is the Table API, whose keys come
from the fused coarsen + pack kernel, as the engine's do.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch

from repro_torch.core import groupby
from repro_torch.core.coarsen import CoarsenSpec
from repro_torch.core.keys import KeyCodec
from repro_torch.data.columnar import Table
from repro_torch.kernels.ops import CutpointTable, cem_keys_columns
from repro_torch.kernels.segment_stats import chunked_sums


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

    def matched_counts(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(treated, control) units in retained groups, as 0-d tensors
        (canonical chunked sums)."""
        sums = chunked_sums(torch.stack([
            torch.where(self.keep, self.n_treated, 0.0),
            torch.where(self.keep, self.n_control, 0.0)], dim=1))
        return sums[0], sums[1]


@dataclasses.dataclass(frozen=True)
class CEMResult:
    """Matched subset + group stats. ``table`` has the column ``subclass``
    (group id) and the validity mask narrowed to matched rows."""

    table: Table
    groups: CEMGroups
    codec: KeyCodec
    key_hi: torch.Tensor
    key_lo: torch.Tensor


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


def cem_from_keys(key_hi: torch.Tensor, key_lo: torch.Tensor,
                  treatment: torch.Tensor, outcome: torch.Tensor,
                  valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, CEMGroups]:
    """CEM core over packed keys. Returns (matched_valid, row_subclass,
    group stats); ``row_subclass`` is the group id per original row
    (meaningless where not matched). The group stats are summed over all
    N group ids by the segment-sum kernel (no host read of the group
    count); the trailing pseudo-group of invalid rows sums to zeros."""
    g = groupby.group_by_key(key_hi, key_lo)
    w = valid.to(torch.float32)
    t = treatment.to(torch.float32) * w
    c = (1.0 - treatment.to(torch.float32)) * w
    y = outcome.to(torch.float32)
    sums = groupby.segment_sums(g, torch.stack([t, c, t * y, c * y], dim=1),
                                g.nrows)
    keep = overlap_keep(g.group_valid, sums[:, 0], sums[:, 1])
    matched_valid = valid & groupby.broadcast_to_rows(g, keep)
    groups = CEMGroups(grouping=g, keep=keep, n_treated=sums[:, 0],
                       n_control=sums[:, 1], sum_y_t=sums[:, 2],
                       sum_y_c=sums[:, 3])
    return matched_valid, g.row_group(), groups


def pack_keys(table: Table, specs: Mapping[str, CoarsenSpec],
              codec: Optional[KeyCodec] = None,
              valid: Optional[torch.Tensor] = None):
    """Coarsen + pack the covariates of ``table`` into (codec, hi, lo)
    through the fused kernel (categorical specs as the cutpoints
    ``1..card-1``, :meth:`CoarsenSpec.kernel_cutpoints`)."""
    codec = codec or make_codec(specs)
    v = table.valid if valid is None else valid
    tab = CutpointTable.for_codec(codec, specs, table.device)
    hi, lo = cem_keys_columns(table.columns, v, tab)
    return codec, hi, lo


def cem(table: Table, treatment: str, outcome: str,
        specs: Mapping[str, CoarsenSpec]) -> CEMResult:
    """CEM over a Table (the paper's Fig. 5(b) view)."""
    codec, hi, lo = pack_keys(table, specs)
    matched_valid, row_subclass, groups = cem_from_keys(
        hi, lo, table[treatment], table[outcome], table.valid)
    out = Table(dict(table.columns), matched_valid).with_columns(
        {"subclass": row_subclass})
    return CEMResult(table=out, groups=groups, codec=codec,
                     key_hi=hi, key_lo=lo)


def exact_matching(table: Table, treatment: str, outcome: str,
                   covariates: Mapping[str, int]) -> CEMResult:
    """EM = CEM with categorical (identity) coarsening; ``covariates`` maps
    name -> cardinality."""
    specs = {n: CoarsenSpec.categorical(c) for n, c in covariates.items()}
    return cem(table, treatment, outcome, specs)
