"""The ingest and query bodies of the online engine — counterpart of the
single-device parts of :mod:`repro.core.fused`, for the replicated layout
and the key-range partitioned one.

The reference compiles the whole ingest into ONE donated XLA program and
picks each view's merge path with ``lax.cond`` on device. PyTorch runs
eagerly, so here the bodies are plain functions the engine calls in order,
and the ``lax.cond`` becomes a host decision: the engine fetches the
fast/slow verdicts of ALL views in one read (``OnlineEngine.host_reads``
counts it), then runs each view's chosen path. ``jit``, donation and
``shard_map`` have no counterpart here.

A view's state is a dict ``st`` with ``hi``, ``lo`` (C,) int64, ``stats``
(C, S) f32, ``gv`` (C,) bool, ``touch`` (C,) int32 and, for treatment
views, ``keep`` (C,) bool — the layout of the reference's state pytree.
On the partitioned layout every field has a leading partition axis —
(P, C) and (P, C, S) — and the deltas are routed: (P, B) rows, row p
holding partition p's share. The verdict of a view stays global (fast
only if every partition is), as in the reference (``fused.py:185``).

In place or not: :func:`merge_fast` updates the view's stats, keep and
touch IN PLACE when ``in_place`` is set (an ingest, which always commits)
and works on copies otherwise (a retraction, which the ``_neg_min`` guard
may still refuse — committed state is untouched until the engine swaps
the new tensors in). :func:`merge_slow` always builds new tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import cube as cube_mod
from repro_torch.core import groupby
from repro_torch.core.ate import estimate_ate_from_stats
from repro_torch.core.cem import overlap_keep, update_overlap
from repro_torch.core.keys import INVALID_HI, INVALID_LO, KeyCodec
from repro_torch.core.propensity import StreamStats
from repro_torch.kernels import segment_stats
from repro_torch.kernels.segment_stats import chunked_sums

BASE_VIEW = "__base__"


def query_stat_names(treatment: str) -> Tuple[str, ...]:
    """The stat columns one treatment's causal query consumes, in the
    order of the estimator's roles (one, y, yy, t, yt, yyt)."""
    return ("one", "y", "yy", f"t_{treatment}", f"yt_{treatment}",
            f"yyt_{treatment}")


# ------------------------------------------------------------ touch stamps
# Both work along the last axis, so a partitioned (P, C) table is stamped
# and remapped partition by partition in one call.
def stamp_touch(touch: torch.Tensor, pos: torch.Tensor, dvalid: torch.Tensor,
                counter: int) -> torch.Tensor:
    """Record the ingest counter at the touched group slots (``fused.py:98``
    of the reference). Invalid delta rows are routed to a scratch slot past
    the end and dropped, so a clipped lookup position can never stamp an
    unrelated live group. The counter is a scalar argument of the scatter,
    not a host tensor copied over. Returns a new tensor."""
    c = touch.shape[-1]
    ext = torch.cat([touch, touch.new_zeros((*touch.shape[:-1], 1))], dim=-1)
    ext.scatter_(-1, torch.where(dvalid, pos, c), counter)
    return ext[..., :c]


def remap_touch(old_hi, old_lo, old_gv, new_hi, new_lo,
                touch: torch.Tensor) -> torch.Tensor:
    """Carry last-touch stamps across a layout-changing (re-sort) merge
    (``fused.py:108``)."""
    c = new_hi.shape[-1]
    pos, found = groupby.lookup_rows_in_table(old_hi, old_lo, new_hi, new_lo)
    out = touch.new_zeros((*touch.shape[:-1], c + 1))
    out.scatter_(-1, torch.where(old_gv & found, pos, c), touch)
    return out[..., :c]


# ----------------------------------------------------------------- merges
def merge_fast(tname: Optional[str], treatments, st: Dict, pos, d_stats,
               d_gv, counter: int, in_place: bool) -> Dict:
    """Fast path of one view's merge — every delta key is already in the
    view: scatter-merge the delta stats at the looked-up positions (the
    scatter-merge kernel; on the partitioned layout the scatter-merge-
    parts kernel, one launch for all partitions), flip overlap at those
    positions, stamp them. ``tname`` is None for the base view (no overlap
    mask). Overlap and stamps run on the flattened (P*C) slots, a
    partition-local position p's slot being ``p*C + pos``."""
    stats = st["stats"] if in_place else st["stats"].clone()
    if stats.dim() == 3:
        cube_mod.scatter_merge_stats_parts(stats, pos, d_stats)
        n_parts, c = st["hi"].shape
        pos = pos + c * torch.arange(n_parts, device=pos.device)[:, None]
    else:
        cube_mod.scatter_merge_stats(stats, pos, d_stats)
    pos, d_gv = pos.reshape(-1), d_gv.reshape(-1)
    touch = stamp_touch(st["touch"].reshape(-1), pos, d_gv, counter)
    new = dict(hi=st["hi"], lo=st["lo"], stats=stats, gv=st["gv"],
               touch=touch.reshape(st["touch"].shape))
    if tname is not None:
        keep = st["keep"] if in_place else st["keep"].clone()
        at = stats.reshape(-1, stats.shape[-1])[pos]
        nt = at[:, cube_mod.stat_column(treatments, f"t_{tname}")]
        n = at[:, cube_mod.stat_column(treatments, "one")]
        update_overlap(keep.view(-1), st["gv"].reshape(-1), nt, n - nt, pos)
        new["keep"] = keep
    return new


def _parts(st: Dict) -> Dict:
    """A view's state with a leading partition axis: a replicated view is
    one partition."""
    return {k: v[None] for k, v in st.items()} if st["hi"].dim() == 1 else st


def merge_slow_groups(st: Dict, d_hi, d_lo) -> groupby.Grouping:
    """First half of the slow path: concat the view's keys and the delta's
    and re-group, every partition in ONE batched group-by sort (a
    replicated view is one partition). ``grouping.n_groups`` (P,) are the
    merged group counts the engine reads and checks against the view's
    capacity."""
    st = _parts(st)
    return groupby.group_by_key(
        torch.cat([st["hi"], d_hi.reshape(st["hi"].shape[0], -1)], dim=1),
        torch.cat([st["lo"], d_lo.reshape(st["lo"].shape[0], -1)], dim=1))


def merge_slow(tname: Optional[str], treatments, st: Dict,
               g: groupby.Grouping, n_merged: Sequence[int], capacity: int,
               d_hi, d_lo, d_stats, d_gv, counter: int) -> Dict:
    """Second half of the slow path, every partition at once at the one
    shared ``capacity`` (>= every ``n_merged``): the merged stats of each
    partition's ``n_merged[p]`` valid groups (ONE segment-sum launch over
    all partitions; each partition's trailing pseudo-group — the view's
    padding slots and the delta's padding rows — is not summed), padded,
    overlap recomputed everywhere, touch stamps carried over and the
    delta's groups stamped. Returns the state in the layout it came in."""
    flat = st["hi"].dim() == 1
    st = _parts(st)
    n_parts, n = g.perm.shape
    d_hi, d_lo, d_gv = (x.reshape(n_parts, -1) for x in (d_hi, d_lo, d_gv))
    s = st["stats"].shape[-1]
    dev = st["hi"].device
    # valid group j of partition p -> row offset[p] + j of the sums (the
    # counts the host read, still on the device: no copy back)
    counts = g.n_groups
    offset = torch.cumsum(counts, 0) - counts
    seg = torch.where(g.seg_ids < counts[:, None],
                      g.seg_ids + offset[:, None], -1)
    rows = g.perm + n * torch.arange(n_parts, device=dev)[:, None]
    sums = segment_stats.segment_sums(
        torch.cat([st["stats"], d_stats.reshape(n_parts, -1, s)],
                  dim=1).reshape(-1, s),
        rows.reshape(-1), seg.reshape(-1), int(sum(n_merged)))
    slot = torch.arange(capacity, device=dev)
    at = torch.where(slot < counts[:, None], slot + offset[:, None],
                     sums.shape[0])
    nstats = torch.cat([sums, sums.new_zeros((1, s))])[at]
    nhi = _pad_slots(g.group_hi, capacity, INVALID_HI)
    nlo = _pad_slots(g.group_lo, capacity, INVALID_LO)
    ngv = _pad_slots(g.group_valid, capacity, False)
    pos2, _ = groupby.lookup_rows_in_table(d_hi, d_lo, nhi, nlo)
    touch = stamp_touch(
        remap_touch(st["hi"], st["lo"], st["gv"], nhi, nlo, st["touch"]),
        pos2, d_gv, counter)
    new = dict(hi=nhi, lo=nlo, stats=nstats, gv=ngv, touch=touch)
    if tname is not None:
        nt = nstats[..., cube_mod.stat_column(treatments, f"t_{tname}")]
        cnt = nstats[..., cube_mod.stat_column(treatments, "one")]
        new["keep"] = overlap_keep(ngv, nt, cnt - nt)
    return {k: v[0] for k, v in new.items()} if flat else new


def _pad_slots(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    """The first ``n`` slots of every partition of a (P, N) tensor, padded
    with ``fill`` past N."""
    if x.shape[1] >= n:
        return x[:, :n]
    out = torch.full((x.shape[0], n), fill, dtype=x.dtype, device=x.device)
    out[:, :x.shape[1]] = x
    return out


def stream_step(stream: StreamStats, columns, valid: torch.Tensor,
                retract: bool) -> StreamStats:
    """Streaming-propensity update (moments + reservoir) of one ingest or
    retraction (``fused.py:262`` of the reference). The engine runs it
    after the retraction guards pass and before the views commit, over the
    batch as given: threefry priorities depend only on a row's index, so
    the reference's power-of-two batch padding changes no draw, and its
    padding rows (invalid, past the end) are never among the survivors.
    No host read: the update is device tensors and host counters only."""
    return stream.update(columns, valid, retract=retract)


def _neg_min(stats: torch.Tensor, treatments) -> torch.Tensor:
    """Minimum over every count column (``one`` and each ``t_*``) of a
    (C, S) or (P, C, S) stats tensor — the retraction-negativity probe."""
    cols = [cube_mod.stat_column(treatments, "one")] + [
        cube_mod.stat_column(treatments, f"t_{t}") for t in treatments]
    # one column at a time: indexing by a list would copy it to the device
    # first, a host -> device transfer the retraction path does not need
    return torch.stack([stats[..., c].min() for c in cols]).min()


# ------------------------------------------------------------------ query
def _query_mask(hi, lo, gv, keep, codec: KeyCodec, subpop):
    """Subpopulation filter + overlap keep as ONE elementwise mask.
    ``subpop`` is the frozen ``((dim, (bucket, ...)), ...)`` predicate."""
    m = gv & keep
    if subpop:
        for dim, allowed in subpop:
            vals = codec.extract(hi, lo, dim)
            ok = torch.zeros_like(m)
            for b in allowed:
                ok = ok | (vals == b)
            m = m & ok
    return m


def _estimate_from_roles(hi, lo, stats: torch.Tensor, m):
    """Canonical estimate over the masked groups: re-sort the surviving
    keys into the canonical (key-sorted, valid-prefix) order — keys are
    unique, so the segment sums are exact gathers — then reduce with the
    capacity-invariant chunked sums. ``stats`` is (C, 6) in the role
    order of :func:`query_stat_names`. The sums stay C rows long (the
    masked group count is not on the host, and a read would add one per
    query); the zero rows past it do not change the chunked sums. Returns
    a dict of 0-d tensors."""
    chi = torch.where(m, hi, INVALID_HI)
    clo = torch.where(m, lo, INVALID_LO)
    g = groupby.group_by_key(chi, clo)
    sums = groupby.segment_sums(g, torch.where(m[:, None], stats, 0.0),
                                g.nrows)
    one, y, yy, t, yt, yyt = sums.unbind(dim=1)
    est = estimate_ate_from_stats(g.group_valid, t, one - t, yt, y - yt,
                                  sum_yy_t=yyt, sum_yy_c=yy - yyt,
                                  sum_fn=chunked_sums)
    return dict(ate=est.ate, att=est.att,
                n_matched_treated=est.n_matched_treated,
                n_matched_control=est.n_matched_control,
                n_groups=est.n_groups, variance=est.variance)


def estimate_view_body(hi, lo, stats, gv, keep, *, codec, treatments,
                       treatment, subpop):
    """Whole causal query over one view's state: mask, then the canonical
    estimate (``fused.py:606``). ``stats`` is the view's full (C, S)
    table; a partitioned view's (P, C) state is flattened to (P*C,) slots
    first. The canonical re-sort and the chunked sums, which trailing zero
    rows do not change, make the answer the replicated layout's bit for
    bit, for any partition count and capacity history."""
    hi, lo, gv, keep = (x.reshape(-1) for x in (hi, lo, gv, keep))
    stats = stats.reshape(-1, stats.shape[-1])
    cols = [cube_mod.stat_column(treatments, k)
            for k in query_stat_names(treatment)]
    m = _query_mask(hi, lo, gv, keep, codec, subpop)
    return _estimate_from_roles(hi, lo, stats[:, cols], m)
