"""The ingest and query bodies of the online engine's replicated layout —
counterpart of the replicated parts of :mod:`repro.core.fused`.

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

In place or not: :func:`merge_fast` updates the view's stats, keep and
touch IN PLACE when ``in_place`` is set (an ingest, which always commits)
and works on copies otherwise (a retraction, which the ``_neg_min`` guard
may still refuse — committed state is untouched until the engine swaps
the new tensors in). :func:`merge_slow` always builds new tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import cube as cube_mod
from repro_torch.core import groupby
from repro_torch.core.ate import estimate_ate_from_stats
from repro_torch.core.cem import overlap_keep, update_overlap
from repro_torch.core.keys import INVALID_HI, INVALID_LO, KeyCodec
from repro_torch.core.propensity import StreamStats
from repro_torch.kernels.segment_stats import chunked_sums

BASE_VIEW = "__base__"


def query_stat_names(treatment: str) -> Tuple[str, ...]:
    """The stat columns one treatment's causal query consumes, in the
    order of the estimator's roles (one, y, yy, t, yt, yyt)."""
    return ("one", "y", "yy", f"t_{treatment}", f"yt_{treatment}",
            f"yyt_{treatment}")


# ------------------------------------------------------------ touch stamps
def stamp_touch(touch: torch.Tensor, pos: torch.Tensor, dvalid: torch.Tensor,
                counter: int) -> torch.Tensor:
    """Record the ingest counter at the touched group slots (``fused.py:98``
    of the reference). Invalid delta rows are routed to a scratch slot past
    the end and dropped, so a clipped lookup position can never stamp an
    unrelated live group. Returns a new (C,) tensor."""
    c = touch.shape[0]
    ext = torch.cat([touch, touch.new_zeros((1,))])
    ext[torch.where(dvalid, pos, c)] = counter
    return ext[:c]


def remap_touch(old_hi, old_lo, old_gv, new_hi, new_lo,
                touch: torch.Tensor) -> torch.Tensor:
    """Carry last-touch stamps across a layout-changing (re-sort) merge
    (``fused.py:108``)."""
    c = new_hi.shape[0]
    pos, found = groupby.lookup_rows_in_table(old_hi, old_lo, new_hi, new_lo)
    out = touch.new_zeros((c + 1,))
    out.scatter_(0, torch.where(old_gv & found, pos, c), touch)
    return out[:c]


# ----------------------------------------------------------------- merges
def merge_fast(tname: Optional[str], treatments, st: Dict, pos, d_stats,
               d_gv, counter: int, in_place: bool) -> Dict:
    """Fast path of one view's merge — every delta key is already in the
    view: scatter-merge the delta stats at the looked-up positions (the
    scatter-merge kernel), flip overlap at those positions, stamp them.
    ``tname`` is None for the base view (no overlap mask)."""
    stats = st["stats"] if in_place else st["stats"].clone()
    cube_mod.scatter_merge_stats(stats, pos, d_stats)
    new = dict(hi=st["hi"], lo=st["lo"], stats=stats, gv=st["gv"],
               touch=stamp_touch(st["touch"], pos, d_gv, counter))
    if tname is not None:
        keep = st["keep"] if in_place else st["keep"].clone()
        at = stats[pos]
        nt = at[:, cube_mod.stat_column(treatments, f"t_{tname}")]
        n = at[:, cube_mod.stat_column(treatments, "one")]
        new["keep"] = update_overlap(keep, st["gv"], nt, n - nt, pos)
    return new


def merge_slow_groups(st: Dict, d_hi, d_lo):
    """First half of the slow path: concat the view's keys and the delta's
    and re-group (group-by sort). ``grouping.n_groups`` is the merged
    group count the engine reads and checks against the view's
    capacity."""
    return groupby.group_by_key(torch.cat([st["hi"], d_hi]),
                                torch.cat([st["lo"], d_lo]))


def merge_slow(tname: Optional[str], treatments, st: Dict, g, n_merged: int,
               capacity: int, d_hi, d_lo, d_stats, d_gv,
               counter: int) -> Dict:
    """Second half of the slow path: the merged stats of the ``n_merged``
    valid groups (segment-sum kernel; the view's padding slots form the
    pseudo-group, which is not summed), padded to ``capacity`` (>=
    ``n_merged``), overlap recomputed everywhere, touch stamps carried over
    and the delta's groups stamped."""
    sums = groupby.segment_sums(g, torch.cat([st["stats"], d_stats]),
                                n_merged)
    nhi = cube_mod.pad_rows(g.group_hi, capacity, INVALID_HI)
    nlo = cube_mod.pad_rows(g.group_lo, capacity, INVALID_LO)
    ngv = cube_mod.pad_rows(g.group_valid, capacity, False)
    nstats = cube_mod.pad_rows(sums, capacity, 0.0)
    pos2, _ = groupby.lookup_rows_in_table(d_hi, d_lo, nhi, nlo)
    touch = stamp_touch(
        remap_touch(st["hi"], st["lo"], st["gv"], nhi, nlo, st["touch"]),
        pos2, d_gv, counter)
    new = dict(hi=nhi, lo=nlo, stats=nstats, gv=ngv, touch=touch)
    if tname is not None:
        nt = nstats[:, cube_mod.stat_column(treatments, f"t_{tname}")]
        n = nstats[:, cube_mod.stat_column(treatments, "one")]
        new["keep"] = overlap_keep(ngv, nt, n - nt)
    return new


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
    """Minimum over every count column (``one`` and each ``t_*``) — the
    retraction-negativity probe."""
    cols = [cube_mod.stat_column(treatments, "one")] + [
        cube_mod.stat_column(treatments, f"t_{t}") for t in treatments]
    return stats[:, cols].min()


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
    table."""
    cols = [cube_mod.stat_column(treatments, k)
            for k in query_stat_names(treatment)]
    m = _query_mask(hi, lo, gv, keep, codec, subpop)
    return _estimate_from_roles(hi, lo, stats[:, cols], m)
