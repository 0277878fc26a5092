"""Sort-based GROUP BY with segmented aggregation — counterpart of
:mod:`repro.core.groupby`.

Rows are sorted by their combined int64 key (:func:`repro_torch.core.keys.
sort_key`) with a stable ``torch.sort`` — a library sort, as the reference
sorted with ``lax.sort`` outside any kernel — then segment boundaries are
marked and the stat bundle is reduced by the segment-sum kernel. The
grouping's outputs are padded to N rows; invalid rows carry the marker
key and form the trailing pseudo-group.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.keys import INVALID_HI, INVALID_LO, sort_key
from repro_torch.kernels import segment_stats


@dataclasses.dataclass(frozen=True)
class Grouping:
    """Result of grouping N rows by key.

    Row-order fields are in *sorted* row order; ``perm`` maps sorted
    position -> original row index.
    """

    perm: torch.Tensor         # (N,) int64: sorted pos -> original row
    seg_ids: torch.Tensor      # (N,) int64: sorted pos -> group id (invalid
                               #   rows share the trailing group)
    group_hi: torch.Tensor     # (N,) int64: group id -> key hi (marker-padded)
    group_lo: torch.Tensor     # (N,) int64
    group_valid: torch.Tensor  # (N,) bool: group id -> real (valid-key) group
    n_groups: torch.Tensor     # () int64, count of valid groups

    @property
    def nrows(self) -> int:
        return int(self.perm.shape[-1])

    def inv_perm(self) -> torch.Tensor:
        """(N,) int64: original row -> sorted pos."""
        inv = torch.empty_like(self.perm)
        inv[self.perm] = torch.arange(self.nrows, device=self.perm.device)
        return inv

    def row_group(self) -> torch.Tensor:
        """(N,) int64: original row -> group id."""
        return self.seg_ids[self.inv_perm()]


def group_by_key(hi: torch.Tensor, lo: torch.Tensor) -> Grouping:
    """Group rows by (hi, lo) key. Invalid rows carry the all-ones marker
    and sort to the end, landing in a trailing pseudo-group flagged
    invalid. The sort is stable, so rows of one group keep their input
    order — the order the segment-sum tree reduces them in. Keys with a
    leading partition axis, (P, N), are grouped partition by partition in
    one batched sort: every field of the grouping is then (P, N) and
    ``n_groups`` (P,)."""
    skey, perm = torch.sort(sort_key(hi, lo), dim=-1, stable=True)
    new_seg = torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    new_seg[..., 1:] = skey[..., 1:] != skey[..., :-1]
    seg_ids = torch.cumsum(new_seg, dim=-1) - 1
    # group id -> key of its rows (every row of a segment has the same key)
    group_hi = torch.full(hi.shape, INVALID_HI, dtype=torch.int64,
                          device=hi.device).scatter_(-1, seg_ids,
                                                     hi.gather(-1, perm))
    group_lo = torch.full(hi.shape, INVALID_LO, dtype=torch.int64,
                          device=hi.device).scatter_(-1, seg_ids,
                                                     lo.gather(-1, perm))
    group_valid = ~((group_hi == INVALID_HI) & (group_lo == INVALID_LO))
    return Grouping(perm=perm, seg_ids=seg_ids, group_hi=group_hi,
                    group_lo=group_lo, group_valid=group_valid,
                    n_groups=group_valid.sum(-1))


def segment_sums(g: Grouping, values: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Per-group sums of the (N, S) stat matrix ``values`` (original row
    order; the kernel gathers through ``g.perm``) for the groups
    ``[0, num_segments)``. Returns (num_segments, S). A caller that knows
    the group count G passes it, and the trailing pseudo-group of invalid
    rows is not summed; one that does not passes ``g.nrows``. Callers
    pre-mask the stats."""
    return segment_stats.segment_sums(values.contiguous(), g.perm,
                                      g.seg_ids, num_segments)


def group_minmax(g: Grouping, col: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group (min, max) over N group ids — the paper's ``min(T) OVER
    w / max(T) OVER w``. Group ids without rows hold the reduction's
    identity (the dtype's largest value for the min, its smallest for the
    max), as ``jax.ops.segment_min`` / ``segment_max`` leave them."""
    sortd = col[g.perm]
    if sortd.dtype.is_floating_point:
        hi, lo = float("inf"), float("-inf")
    else:
        info = torch.iinfo(sortd.dtype)
        hi, lo = info.max, info.min
    mn = torch.full((g.nrows,), hi, dtype=sortd.dtype, device=sortd.device)
    mx = torch.full((g.nrows,), lo, dtype=sortd.dtype, device=sortd.device)
    mn = mn.scatter_reduce(0, g.seg_ids, sortd, "amin", include_self=True)
    mx = mx.scatter_reduce(0, g.seg_ids, sortd, "amax", include_self=True)
    return mn, mx


def broadcast_to_rows(g: Grouping, group_vals: torch.Tensor) -> torch.Tensor:
    """Group-level values -> per-row values (original row order): the SQL
    analogue of selecting a window aggregate alongside each row."""
    return group_vals[g.seg_ids][g.inv_perm()]


def scatter_add_stats(stats: torch.Tensor, pos: torch.Tensor,
                      delta: torch.Tensor) -> torch.Tensor:
    """Merge a (B, S) delta stat table into the (C, S) ``stats`` IN PLACE at
    known positions (non-decreasing on CUDA) — the O(|delta|) fast path of
    online view maintenance, through the scatter-merge kernel."""
    return segment_stats.scatter_merge(stats, pos.contiguous(),
                                       delta.contiguous())


def lookup_rows_in_table(hi: torch.Tensor, lo: torch.Tensor,
                         table_hi: torch.Tensor, table_lo: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row key, its position in a *sorted* key table: the lower
    bound of the key (``searchsorted`` on the combined key, the same bound
    the reference's binary search finds, invalid rows included), clipped
    to the last slot. Returns (pos int64, found bool). Tables and rows may
    carry a leading partition axis — (P, C) tables, (P, B) rows — and row
    p is then looked up in table p (the routed deltas of the partitioned
    layout)."""
    pos = torch.searchsorted(sort_key(table_hi, table_lo),
                             sort_key(hi, lo), side="left")
    pos = torch.clamp(pos, 0, table_hi.shape[-1] - 1)
    found = ((torch.gather(table_hi, -1, pos) == hi)
             & (torch.gather(table_lo, -1, pos) == lo))
    return pos, found


def lookup_rows_in_parts(hi: torch.Tensor, lo: torch.Tensor,
                         pid: torch.Tensor, table_hi: torch.Tensor,
                         table_lo: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row lookup against a STACK of sorted key tables
    (``groupby.py:188``): row i is searched in partition ``pid[i]`` of the
    (P, C) tables. Every row is searched in each of the P tables (one
    batched ``searchsorted``) and its own partition's answer kept. Returns
    (pos, found) as :func:`lookup_rows_in_table`, ``pos`` indexing
    partition ``pid[i]``'s slots, clipped to ``[0, C)``."""
    n_parts, c = table_hi.shape
    probe = sort_key(hi, lo)
    every = torch.searchsorted(sort_key(table_hi, table_lo),
                               probe.expand(n_parts, -1).contiguous(),
                               side="left")
    pos = torch.clamp(every.gather(0, pid[None, :])[0], 0, c - 1)
    found = (table_hi[pid, pos] == hi) & (table_lo[pid, pos] == lo)
    return pos, found
