"""The stat-table kernels of the online engine: segment sums (GROUP BY),
the fast-path scatter merge, and the canonical chunked query sums — each a
CUDA kernel wrapper beside its plain PyTorch version.

Replaces, in ``repro/kernels/segment_stats.py``:

- ``segment_partials_pallas`` + ``combine_partials`` -> :func:`segment_sums`
  (``csrc/segment_sums.cu``)
- ``scatter_merge_pallas`` -> :func:`scatter_merge` (``csrc/scatter_merge.cu``)
- ``scatter_merge_parts_pallas`` -> :func:`scatter_merge_parts`
  (``csrc/scatter_merge_parts.cu``)
- ``chunk_sums_pallas`` + the sequential combine of ``chunked_sum``
  -> :func:`chunk_sums` (``csrc/chunk_sums.cu``)

The bit-identity contract of the online engine (``docs/architecture.md``)
rules out float atomics and any sum whose order is not pinned. Each kernel
fixes its order, and each plain version below writes the SAME order with
vectorized tensor ops, so kernel and plain version agree bit for bit:

- segment sums: a pairwise tree over each segment's rows, relative to the
  segment's first row (``csrc/segment_tree.cuh`` builds it in 256-row
  tiles, a warp per window of rows, then folds a longer segment's tile
  sums by the same tree);
- scatter merge: each destination's run of duplicate positions summed by
  the same tree, in delta-row order, then added onto the table cell (per
  partition, for the partitioned merge: runs are keyed by (partition,
  position));
- chunk sums: ten halving steps per 1024-row chunk (a warp's registers
  and shuffles, ``csrc/chunk_tree.cuh``), then the chunks combined
  strictly in order, in the same launch.

CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

SEGMENT_SUMS = build.KERNELS["segment_sums"]
SCATTER_MERGE = build.KERNELS["scatter_merge"]
SCATTER_MERGE_PARTS = build.KERNELS["scatter_merge_parts"]
CHUNK_SUMS = build.KERNELS["chunk_sums"]

# canonical chunk width of the capacity-invariant query reductions
CANONICAL_BLOCK = 1024
# rows per tile of the segment-sum and scatter-merge kernels, which is
# also the window of rows each warp of their tile pass owns
# (REPRO_TREE_TILE in csrc/segment_tree.cuh); the tests emulate their
# loops with it
SEGMENT_TILE = 256


def _tree_scratch(n: int, s: int, dev: torch.device) -> torch.Tensor:
    """Scratch of the tree kernels (``csrc/segment_tree.cuh``): per window
    of SEGMENT_TILE rows, 2 + S int64 words — a fold record and two tile
    sums of S floats. Sized by tiles, not rows; the kernels write every
    word they read, so it is not filled."""
    return torch.empty((-(-n // SEGMENT_TILE), 2 + s), dtype=torch.int64,
                       device=dev)


def _run_starts(keys: torch.Tensor) -> torch.Tensor:
    """(N,) bool: row i starts a run of equal ``keys`` (sorted input)."""
    flag = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    flag[1:] = keys[1:] != keys[:-1]
    return flag


# ------------------------------------------------------------ segment sums
def segment_sums_plain(values: torch.Tensor, perm: torch.Tensor,
                       seg_ids: torch.Tensor, num_segments: int
                       ) -> torch.Tensor:
    """values (N, S) f32; perm (N,) int64 sorted row -> original row;
    seg_ids (N,) int64, non-decreasing. Returns (num_segments, S): the sum
    of ``values[perm[r]]`` over the rows r of each segment, as a pairwise
    tree over the segment's own rows (ids outside the range are dropped)."""
    n, s = values.shape
    out = torch.zeros((num_segments, s), dtype=torch.float32,
                      device=values.device)
    if n == 0 or s == 0:
        return out
    x = values[perm]
    idx = torch.arange(n, device=values.device)
    starts = _run_starts(seg_ids)
    ends = torch.ones_like(starts)
    ends[:-1] = starts[1:]
    first = torch.cummax(torch.where(starts, idx, 0), dim=0).values
    last = torch.flip(torch.cummin(torch.flip(
        torch.where(ends, idx, n - 1), [0]), dim=0).values, [0])
    rel = idx - first
    length = last - first + 1
    longest = int(length.max())
    h = 1
    while h < longest:
        join = ((rel % (2 * h)) == 0) & (rel + h < length)
        right = torch.zeros_like(x)
        right[:-h] = x[h:]
        x = torch.where(join[:, None], x + right, x)
        h *= 2
    sel = starts & (seg_ids >= 0) & (seg_ids < num_segments)
    out[seg_ids[sel]] = x[sel]
    return out


def segment_sums(values: torch.Tensor, perm: torch.Tensor,
                 seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Same contract as :func:`segment_sums_plain`."""
    if values.device.type == "cpu":
        return segment_sums_plain(values, perm, seg_ids, num_segments)
    dev = build.require_cuda("segment_sums", values, perm, seg_ids)
    n, s = values.shape
    build.check("segment_sums values", values, torch.float32, (n, s))
    build.check("segment_sums perm", perm, torch.int64, (n,))
    build.check("segment_sums seg_ids", seg_ids, torch.int64, (n,))
    # zeros: a segment with no rows keeps its row of +0.0
    out = torch.zeros((num_segments, s), dtype=torch.float32, device=dev)
    if n and s and num_segments:
        SEGMENT_SUMS.launch(dev, values.data_ptr(), perm.data_ptr(),
                            seg_ids.data_ptr(),
                            _tree_scratch(n, s, dev).data_ptr(),
                            out.data_ptr(), n, s, num_segments)
    return out


# ----------------------------------------------------------- scatter merge
def scatter_merge_plain(table: torch.Tensor, pos: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """IN PLACE: ``table[pos[j]] += vals[j]`` for (C, S) ``table``, (B,)
    int64 ``pos`` and (B, S) ``vals``. Each run of duplicate positions is
    summed as the segment-sum tree in delta-row order, then added onto the
    cell once; positions outside [0, C) are dropped. Returns ``table``.
    (Any ``pos`` order is accepted here; the kernel requires non-decreasing
    ``pos``.)"""
    if pos.shape[0] == 0:
        return table
    order = torch.argsort(pos, stable=True)
    p = pos[order]
    head = _run_starts(p)
    runs = segment_sums_plain(vals, order, torch.cumsum(head, 0) - 1,
                              int(head.sum()))
    dst = p[head]
    inside = (dst >= 0) & (dst < table.shape[0])
    table[dst[inside]] = table[dst[inside]] + runs[inside]
    return table


def scatter_merge(table: torch.Tensor, pos: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`scatter_merge_plain` (in place). On CUDA
    ``pos`` must be non-decreasing — the online fast path guarantees it —
    and an empty delta launches nothing."""
    if table.device.type == "cpu":
        return scatter_merge_plain(table, pos, vals)
    dev = build.require_cuda("scatter_merge", table, pos, vals)
    c, s = table.shape
    b = pos.shape[0]
    build.check("scatter_merge table", table, torch.float32, (c, s))
    build.check("scatter_merge pos", pos, torch.int64, (b,))
    build.check("scatter_merge vals", vals, torch.float32, (b, s))
    if b and s and c:
        SCATTER_MERGE.launch(dev, table.data_ptr(), pos.data_ptr(),
                             vals.data_ptr(),
                             _tree_scratch(b, s, dev).data_ptr(), b, s, c)
    return table


# ------------------------------------------------- partitioned scatter merge
def _part_slots(pos: torch.Tensor, c: int) -> torch.Tensor:
    """(P, B) partition-local positions -> (P*B,) slots ``p*C + pos`` of the
    flattened (P*C) tables; positions outside [0, C) become -1 BEFORE the
    offset, so they are dropped and never spill into a neighbour."""
    p = pos.shape[0]
    base = c * torch.arange(p, device=pos.device)[:, None]
    return torch.where((pos >= 0) & (pos < c), pos + base, -1).reshape(-1)


def scatter_merge_parts_plain(tables: torch.Tensor, pos: torch.Tensor,
                              vals: torch.Tensor) -> torch.Tensor:
    """IN PLACE: ``tables[p, pos[p, j]] += vals[p, j]`` for (P, C, S)
    contiguous ``tables``, (P, B) int64 ``pos`` and (P, B, S) ``vals`` —
    :func:`scatter_merge_plain` of partition p's rows onto partition p's
    table, for every p, bit for bit: one flattened call whose runs are
    keyed by (partition, position). Any order of ``pos`` is accepted here;
    the kernel requires positions non-decreasing within each partition.
    Returns ``tables``."""
    p, c, s = tables.shape
    scatter_merge_plain(tables.view(p * c, s), _part_slots(pos, c),
                        vals.reshape(-1, s))
    return tables


def scatter_merge_parts(tables: torch.Tensor, pos: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`scatter_merge_parts_plain` (in place). On
    CUDA, ONE launch for all partitions; ``pos`` must be non-decreasing
    within each partition — the partitioned fast path guarantees it — and
    an empty delta launches nothing."""
    if tables.device.type == "cpu":
        return scatter_merge_parts_plain(tables, pos, vals)
    dev = build.require_cuda("scatter_merge_parts", tables, pos, vals)
    p, c, s = tables.shape
    b = pos.shape[-1]
    build.check("scatter_merge_parts tables", tables, torch.float32,
                (p, c, s))
    build.check("scatter_merge_parts pos", pos, torch.int64, (p, b))
    build.check("scatter_merge_parts vals", vals, torch.float32, (p, b, s))
    if p and b and s and c:
        # scratch: each row's global slot (or -1), and the tree's
        slots = torch.empty((p * b,), dtype=torch.int64, device=dev)
        SCATTER_MERGE_PARTS.launch(dev, tables.data_ptr(), pos.data_ptr(),
                                   vals.data_ptr(), slots.data_ptr(),
                                   _tree_scratch(p * b, s, dev).data_ptr(),
                                   p, b, s, c)
    return tables


# -------------------------------------------------------- canonical sums
def _n_chunks(n: int) -> int:
    return max(1, -(-n // CANONICAL_BLOCK))


def chunk_sums_plain(values: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """values (N, S) f32 -> (partials (nb, S), totals (S,)). Each 1024-row
    chunk (zero-padded) reduces by ten halving steps ``x[i] + x[i+512]``,
    ``+256``, ..., ``+1``; the totals add the chunk partials strictly in
    order, so trailing zero rows never change them."""
    n, s = values.shape
    nb = _n_chunks(n)
    x = torch.zeros((nb * CANONICAL_BLOCK, s), dtype=torch.float32,
                    device=values.device)
    x[:n] = values
    x = x.reshape(nb, CANONICAL_BLOCK, s)
    h = CANONICAL_BLOCK // 2
    while h >= 1:
        x = x[:, :h] + x[:, h:2 * h]
        h //= 2
    partials = x[:, 0]
    total = partials[0].clone()
    for c in range(1, nb):
        total = total + partials[c]
    return partials, total


def chunk_sums(values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`chunk_sums_plain`; on CUDA one launch, the
    partials and the totals views of one (nb + 1, S) buffer. Its last
    block combines by a ticket on the counter of the current stream
    (:func:`build.ticket`): two calls on one stream are serialised by the
    stream, so they never hold the counter at once."""
    if values.device.type == "cpu":
        return chunk_sums_plain(values)
    dev = build.require_cuda("chunk_sums", values)
    n, s = values.shape
    build.check("chunk_sums values", values, torch.float32, (n, s))
    nb = _n_chunks(n)
    out = torch.empty((nb + 1, s), dtype=torch.float32, device=dev)
    if s:
        CHUNK_SUMS.launch(dev, values.data_ptr(), out.data_ptr(), n, s, nb)
    return out[:nb], out[nb]


def chunked_sums(values: torch.Tensor) -> torch.Tensor:
    """(N, S) -> (S,) capacity-invariant canonical column sums: the
    ``sum_fn`` of the online query's estimator, one launch for all the
    vectors one estimator stage reduces."""
    return chunk_sums(values)[1]


def chunked_sum(x: torch.Tensor) -> torch.Tensor:
    """Canonical sum of one zero-tail-padded vector (``chunked_sum`` of the
    reference)."""
    return chunked_sums(x.reshape(-1, 1).contiguous())[0]
