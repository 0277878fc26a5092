"""Group-stat tables (cuboids) of the online engine — counterpart of the
parts of :mod:`repro.core.cube` that the replicated ingest path uses.

A :class:`Cuboid` is a key-sorted group-stat table: packed keys plus the
decomposable sums (counts and first and second moments per treatment arm)
that CEM and the ATE need, so rollups and merges are exact.

Layout: the stats of a table are ONE contiguous (C, S) float32 tensor,
columns in ``sorted(stat_names(treatments))`` order — the order the
reference stacks them in for its scatter-merge kernel (``cube.py:234``),
so a merge needs no stacking. :func:`stat_column` maps a name to its
column.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence, Tuple

import torch

from repro_torch.core import groupby
from repro_torch.core.keys import INVALID_HI, INVALID_LO, KeyCodec
from repro_torch.kernels.ops import CutpointTable, cem_keys_columns


@dataclasses.dataclass(frozen=True)
class Cuboid:
    """Group-stat table over a set of dims (coarsened covariates).

    stats (C, S), columns ``sorted(stat_names(treatments))``:
      "one" -> n rows, "y" -> sum outcome, "yy" -> sum outcome^2, and per
      treatment t: "t_t" -> n treated, "yt_t" -> sum outcome over treated,
      "yyt_t" -> sum outcome^2 over treated.
    """

    codec: KeyCodec
    key_hi: torch.Tensor       # (C,) int64 u32 words, marker-padded
    key_lo: torch.Tensor
    stats: torch.Tensor        # (C, S) f32
    group_valid: torch.Tensor  # (C,) bool
    treatments: Tuple[str, ...]

    @property
    def capacity(self) -> int:
        return int(self.key_hi.shape[0])

    def n_groups(self) -> torch.Tensor:
        return self.group_valid.sum()


def stat_names(treatments: Sequence[str]) -> Tuple[str, ...]:
    """The decomposable stat columns a cuboid carries for ``treatments``
    (the reference's order; tables store them sorted)."""
    names = ["one", "y", "yy"]
    for t in treatments:
        names += [f"t_{t}", f"yt_{t}", f"yyt_{t}"]
    return tuple(names)


def stat_column(treatments: Sequence[str], name: str) -> int:
    """Column of stat ``name`` in a (C, S) stats tensor."""
    return sorted(stat_names(treatments)).index(name)


def delta_stat_columns(columns: Mapping[str, torch.Tensor],
                       valid: torch.Tensor, treatments: Sequence[str],
                       outcome: str) -> torch.Tensor:
    """(N, S) per-row contributions to every cuboid stat (masked by
    validity), columns sorted by name. Same expressions as the reference,
    so the per-row products round identically."""
    w = valid.to(torch.float32)
    y = columns[outcome].to(torch.float32)
    cols = {"one": w, "y": w * y, "yy": w * y * y}
    for t in treatments:
        tv = columns[t].to(torch.float32) * w
        cols[f"t_{t}"] = tv
        cols[f"yt_{t}"] = tv * y
        cols[f"yyt_{t}"] = tv * y * y
    return torch.stack([cols[k] for k in sorted(cols)], dim=1)


def empty_cuboid(codec: KeyCodec, treatments: Sequence[str], capacity: int,
                 device) -> Cuboid:
    """All-invalid cuboid of ``capacity`` slots — the seed state of online
    delta maintenance (the first ingest takes the re-sort merge path)."""
    return Cuboid(
        codec=codec,
        key_hi=torch.full((capacity,), INVALID_HI, dtype=torch.int64,
                          device=device),
        key_lo=torch.full((capacity,), INVALID_LO, dtype=torch.int64,
                          device=device),
        stats=torch.zeros((capacity, len(stat_names(treatments))),
                          dtype=torch.float32, device=device),
        group_valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        treatments=tuple(treatments))


def delta_build_body(columns, valid, *, cutpoints: CutpointTable,
                     treatments, outcome,
                     read_count: Callable[[torch.Tensor], int]):
    """coarsen + pack (the cem_keys kernel) -> group -> segment-sum (the
    segment-sum kernel): the build body of a delta stat table
    (``cube.py:115`` of the reference), at its exact group count.
    ``read_count`` brings the group count to the host; the segment sums
    then cover only the G valid groups, so the trailing pseudo-group of
    invalid rows is never summed. Returns (hi, lo, sums (G, S)), the
    delta's groups key-sorted."""
    hi, lo = cem_keys_columns(columns, valid, cutpoints)
    g = groupby.group_by_key(hi, lo)
    n = read_count(g.n_groups)
    sums = groupby.segment_sums(
        g, delta_stat_columns(columns, valid, treatments, outcome), n)
    return g.group_hi[:n], g.group_lo[:n], sums


def rollup_body(codec: KeyCodec, dims: Tuple[str, ...], key_hi, key_lo,
                group_valid, stats):
    """Re-key a stat table onto a subset of its dims and re-aggregate (the
    body of the reference's ``_rollup_fn``, ``cube.py:160``). Returns
    (hi, lo, sums, group_valid), as long as the input: the rolled-up
    group count stays on the device (reading it would cost a host read per
    ingest)."""
    _, shi, slo = codec.rollup(key_hi, key_lo, dims, group_valid)
    g = groupby.group_by_key(shi, slo)
    sums = groupby.segment_sums(g, stats, g.nrows)
    return g.group_hi, g.group_lo, sums, g.group_valid


def scatter_merge_stats(stats: torch.Tensor, pos: torch.Tensor,
                        delta_stats: torch.Tensor) -> torch.Tensor:
    """Fast-path stat merge (``cube.py:226``), IN PLACE on ``stats``: on
    CUDA always the scatter-merge kernel, whose precondition (non-decreasing
    ``pos``) the fast path meets. Callers that may still refuse the merge
    pass a copy."""
    return groupby.scatter_add_stats(stats, pos, delta_stats)


def _pad_cuboid(cuboid: Cuboid, capacity: int) -> Cuboid:
    """Pad to ``capacity`` slots (invalid-key marker, zero stats), keeping
    the table sorted and binary-searchable (``cube.py:425``)."""
    pad = capacity - cuboid.capacity
    if pad < 0:
        raise ValueError("cannot shrink in _pad_cuboid")
    if pad == 0:
        return cuboid
    return Cuboid(
        codec=cuboid.codec,
        key_hi=pad_rows(cuboid.key_hi, capacity, INVALID_HI),
        key_lo=pad_rows(cuboid.key_lo, capacity, INVALID_LO),
        stats=pad_rows(cuboid.stats, capacity, 0.0),
        group_valid=pad_rows(cuboid.group_valid, capacity, False),
        treatments=cuboid.treatments)


def pad_rows(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    """First ``n`` rows of ``x``, padded with ``fill`` past its end."""
    if x.shape[0] >= n:
        return x[:n]
    out = torch.full((n, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    out[:x.shape[0]] = x
    return out
