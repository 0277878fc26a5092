"""Group-stat tables (cuboids) of the online engine — counterpart of the
parts of :mod:`repro.core.cube` that the replicated and the key-range
partitioned ingest paths use.

A :class:`Cuboid` is a key-sorted group-stat table: packed keys plus the
decomposable sums (counts and first and second moments per treatment arm)
that CEM and the ATE need, so rollups and merges are exact. A
:class:`PartitionedCuboid` is ``P`` such tables stacked at one shared
capacity: partition p holds the keys whose hash falls in the p-th range
(:func:`partition_ids`).

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
from repro_torch.core.cem import overlap_keep
from repro_torch.core.keys import INVALID_HI, INVALID_LO, MASK32, KeyCodec
from repro_torch.kernels import segment_stats
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


# ===================== key-range partitioned views ==========================
def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for u32 words ``a`` held in int64 and a u32
    constant ``c``, in 16-bit halves of ``c`` so that no int64 product
    overflows (a full u32 x u32 product would need 64 unsigned bits)."""
    lo16 = a * (c & 0xFFFF)
    hi16 = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo16 + hi16) & MASK32


def _hash32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche hash of a packed (hi, lo) key — the murmur3
    finalizer of ``cube.py:338``, in u32 arithmetic on int64 words: every
    product is reduced mod 2^32 before the next shift, so ``>>`` never sees
    a negative value."""
    h = lo ^ _mul32(hi, 0x9E3779B1)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def partition_ids(hi: torch.Tensor, lo: torch.Tensor,
                  n_parts: int) -> torch.Tensor:
    """Owning partition of each key (``cube.py:351``): partition p owns the
    p-th contiguous range of the hash space, ``(hash * n_parts) >> 32`` by
    an exact multiply-high in 16-bit halves (any ``n_parts`` < 2^16).
    Returns int64 ids in ``[0, n_parts)``."""
    if n_parts == 1:
        return torch.zeros_like(hi)
    if n_parts >= 1 << 16:
        raise ValueError(f"n_parts {n_parts} >= 2^16")
    h = _hash32(hi, lo)
    t = (h >> 16) * n_parts + (((h & 0xFFFF) * n_parts) >> 16)
    return t >> 16


@dataclasses.dataclass(frozen=True)
class PartitionedCuboid:
    """Key-range partitioned group-stat table (``cube.py:372``): row p of
    every tensor is partition p's sorted stat table, marker-padded to the
    shared per-partition capacity C. Same stat schema and column order as
    :class:`Cuboid`."""

    codec: KeyCodec
    key_hi: torch.Tensor       # (P, C) int64 u32 words
    key_lo: torch.Tensor
    stats: torch.Tensor        # (P, C, S) f32
    group_valid: torch.Tensor  # (P, C) bool
    treatments: Tuple[str, ...]

    @property
    def n_parts(self) -> int:
        return int(self.key_hi.shape[0])

    @property
    def capacity(self) -> int:
        """Slots PER PARTITION."""
        return int(self.key_hi.shape[1])

    def n_groups(self) -> torch.Tensor:
        return self.group_valid.sum()


def stack_partitions(parts: Sequence[Cuboid]) -> PartitionedCuboid:
    """Stack per-partition tables, padded to the largest capacity
    (``cube.py:467``)."""
    cap = max(p.capacity for p in parts)
    parts = [_pad_cuboid(p, cap) for p in parts]
    return PartitionedCuboid(
        codec=parts[0].codec,
        key_hi=torch.stack([p.key_hi for p in parts]),
        key_lo=torch.stack([p.key_lo for p in parts]),
        stats=torch.stack([p.stats for p in parts]),
        group_valid=torch.stack([p.group_valid for p in parts]),
        treatments=parts[0].treatments)


def empty_partitioned(codec: KeyCodec, treatments: Sequence[str],
                      n_parts: int, capacity: int,
                      device) -> PartitionedCuboid:
    """All-invalid (P, capacity) table — the seed state of a partitioned
    view."""
    return stack_partitions([empty_cuboid(codec, treatments, capacity,
                                          device)] * n_parts)


def route_delta(hi: torch.Tensor, lo: torch.Tensor, stats: torch.Tensor,
                gv: torch.Tensor, n_parts: int):
    """Route a key-sorted delta stat table (unique valid keys, invalid rows
    anywhere) to its owner partitions (``cube.py:580``). Returns (hi, lo,
    stats, gv) with a leading ``n_parts`` axis and as many rows per
    partition as the delta has (B): row p holds partition p's valid rows
    in key order, then the invalid marker with zero stats. No host read:
    a row's slot is its rank among the earlier rows of its partition (a
    cumulative count), and invalid rows go to a partition past the last,
    which is dropped. The stats are gathered, not re-summed, so they stay
    exact."""
    b = hi.shape[0]
    pid = torch.where(gv, partition_ids(hi, lo, n_parts), n_parts)
    # (P+1, B): the running count runs along the last axis (a scan down
    # the leading axis of a (B, P+1) tensor is one thread per column)
    onehot = torch.arange(n_parts + 1, device=hi.device)[:, None] == pid
    rank = torch.cumsum(onehot, dim=1).gather(0, pid[None, :])[0] - 1

    def place(x, fill):
        out = torch.full((n_parts + 1, b, *x.shape[1:]), fill,
                         dtype=x.dtype, device=x.device)
        out[pid, rank] = x
        return out[:n_parts]

    return (place(hi, INVALID_HI), place(lo, INVALID_LO), place(stats, 0.0),
            place(gv, False))


def scatter_merge_stats_parts(stats: torch.Tensor, pos: torch.Tensor,
                              delta_stats: torch.Tensor) -> torch.Tensor:
    """Partition-local fast-path merge (``cube.py:603``), IN PLACE on the
    (P, C, S) ``stats``: each partition's routed delta rows added onto its
    own table at its (P, B) positions. On CUDA always the scatter-merge-
    parts kernel (one launch for all partitions), whose precondition
    (positions non-decreasing within each partition) the fast path meets.
    Callers that may still refuse the merge pass a copy."""
    return segment_stats.scatter_merge_parts(stats, pos.contiguous(),
                                             delta_stats.contiguous())


def unpartition_view(pcub: PartitionedCuboid, treatment: str
                     ) -> Tuple[Cuboid, torch.Tensor]:
    """(canonical cuboid, overlap keep) of one partitioned view
    (``cube.py:522-546``): the (P, C) tables flattened and re-sorted into
    ONE key-sorted table. Keys are distinct across partitions, so the
    segment sums are gathers and the stats stay exact; the keep mask is
    recomputed from them. The table is P*C rows long, its valid groups a
    sorted prefix."""
    g = groupby.group_by_key(pcub.key_hi.reshape(-1),
                             pcub.key_lo.reshape(-1))
    sums = groupby.segment_sums(
        g, pcub.stats.reshape(-1, pcub.stats.shape[-1]), g.nrows)
    nt = sums[:, stat_column(pcub.treatments, f"t_{treatment}")]
    n = sums[:, stat_column(pcub.treatments, "one")]
    return (Cuboid(codec=pcub.codec, key_hi=g.group_hi, key_lo=g.group_lo,
                   stats=sums, group_valid=g.group_valid,
                   treatments=pcub.treatments),
            overlap_keep(g.group_valid, nt, n - nt))
