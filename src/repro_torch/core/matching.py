"""Nearest-neighbour matching (paper §3.1, Figs. 2-3) — counterpart of
:mod:`repro.core.matching`.

NNMWR (with replacement): for each treated unit, its k nearest control
units within the caliper. Two engines:

* ``knn_quadratic``: all-pairs distances with a running top-k — the
  paper's "by necessity quadratic" general path — in one launch of the
  k-NN kernel (:mod:`repro_torch.kernels.knn_topk`).
* ``knn_sorted_1d``: the 1-D fast path (propensity distance): sort the
  controls, binary-search each query, take the k nearest of a 2k window.

NNMNR (without replacement): the paper's greedy half-approximation (its
Fig. 3): candidate edges sorted by distance (stable), then the sequential
sweep keeping the 1:k invariant, in one launch of the sweep kernel
(:mod:`repro_torch.kernels.greedy_sweep`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels.greedy_sweep import greedy_sweep
from repro_torch.kernels.knn_topk import BIG, knn_topk_op
from repro_torch.kernels.segment_stats import chunked_sums


@dataclasses.dataclass(frozen=True)
class MatchResult:
    """k matches per row. Tensors are (N, k) aligned to the *original* row
    order; rows that are not valid treated units have all-invalid
    matches."""

    idx: torch.Tensor           # (N, k) int64 control row indices
    dist: torch.Tensor          # (N, k) f32
    ok: torch.Tensor            # (N, k) bool — match exists & within caliper
    treated_mask: torch.Tensor  # (N,) bool — rows that sought matches

    def n_matched_treated(self) -> torch.Tensor:
        return (self.ok.any(dim=1) & self.treated_mask).sum()


def knn_quadratic(U_treated: torch.Tensor, U_control: torch.Tensor,
                  control_valid: torch.Tensor, k: int, caliper: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs k-NN: (Nt, d) vs (Nc, d) -> (Nt, k) (dist, idx): Euclidean
    distances (BIG beyond the caliper) and control indices; a slot without
    a valid control holds idx -1 and distance sqrt(BIG) before the
    caliper."""
    return knn_topk_op(U_treated, U_control, control_valid, k, caliper)


def knn_sorted_1d(x_treated: torch.Tensor, x_control: torch.Tensor,
                  control_valid: torch.Tensor, k: int, caliper: float,
                  window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-D k-NN fast path (propensity distance), O(N log N).

    ``window`` defaults to k: the candidates are the k controls left and k
    right of the insertion point (``searchsorted``, left side), which hold
    the true k nearest in 1-D. The k nearest of the 2k window come from a
    stable ascending sort, so equal distances keep window order, as
    ``lax.top_k`` keeps them. Candidates outside the control range hold
    BIG and the index of the clipped position, as in the reference."""
    w = window or k
    nc = x_control.shape[0]
    dev = x_control.device
    xc = torch.where(control_valid, x_control.to(torch.float32), BIG)
    xs, perm = torch.sort(xc, stable=True)
    xt = x_treated.to(torch.float32)
    pos = torch.searchsorted(xs, xt.contiguous(), side="left")
    cand = pos[:, None] + torch.arange(-w, w, device=dev)[None, :]
    inb = (cand >= 0) & (cand < nc)
    cand = torch.clamp(cand, 0, nc - 1)
    xcand = xs[cand]
    cd = torch.where(inb & (xcand < BIG), torch.abs(xcand - xt[:, None]), BIG)
    dist, order = torch.sort(cd, dim=1, stable=True)
    dist, order = dist[:, :k], order[:, :k]
    idx = torch.gather(perm[cand], 1, order)
    return torch.where(dist <= caliper, dist, BIG), idx


def nnmwr(U: torch.Tensor, treatment: torch.Tensor, valid: torch.Tensor,
          k: int, caliper: float, engine: str = "auto") -> MatchResult:
    """k:1 NNM with replacement over the feature matrix U (N, d).

    All N rows are queries (as in the reference); rows with treatment 0 or
    invalid are masked out of the result. ``engine`` "auto" takes the 1-D
    fast path for d = 1 and the quadratic k-NN otherwise."""
    tb = treatment.to(torch.bool)
    t = tb & valid
    c = ~tb & valid
    if engine == "auto":
        engine = "sorted1d" if U.shape[1] == 1 else "quadratic"
    if engine == "sorted1d":
        dist, idx = knn_sorted_1d(U[:, 0], U[:, 0], c, k, caliper)
    else:
        dist, idx = knn_quadratic(U, U, c, k, caliper)
    ok = (dist < BIG) & t[:, None]
    return MatchResult(idx=idx, dist=dist, ok=ok, treated_mask=t)


def nnmwr_att(y: torch.Tensor, result: MatchResult) -> torch.Tensor:
    """ATT from a with-replacement match: mean over matched treated units
    of (y_i - mean(y of matched controls)). The k matches of a row add in
    slot order; the sums over rows are canonical chunked sums."""
    yf = y.to(torch.float32)
    ok = result.ok
    ym_rows = yf[torch.clamp(result.idx, min=0)]
    n_ok = ok[:, 0].to(torch.float32)
    s = torch.where(ok[:, 0], ym_rows[:, 0], 0.0)
    for j in range(1, ok.shape[1]):
        n_ok = n_ok + ok[:, j].to(torch.float32)
        s = s + torch.where(ok[:, j], ym_rows[:, j], 0.0)
    ym = s / torch.clamp(n_ok, min=1e-9)
    has = n_ok > 0
    tot = chunked_sums(torch.stack([torch.where(has, yf - ym, 0.0),
                                    has.to(torch.float32)], dim=1))
    return tot[0] / torch.clamp(tot[1], min=1e-9)


def greedy_nnmnr(cand_dist: torch.Tensor, cand_idx: torch.Tensor,
                 treated_rows: torch.Tensor, n_rows: int, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy without-replacement sweep (paper Fig. 3).

    cand_dist / cand_idx: (Nt, m) candidate matches per treated row (from
    a with-replacement k'-NN with k' = m >= k). Edges are sorted by
    distance (stable ascending, so equal distances keep row-major order)
    and swept by the kernel: a control is taken at most once, a treated
    row takes at most k controls. Returns (take (Nt, m) bool over the
    candidate slots, the sweep order) — the 1/2-approximation of optimal
    matching."""
    nt, m = cand_dist.shape
    flat_d = cand_dist.reshape(-1)
    flat_c = cand_idx.reshape(-1).to(torch.int64)
    flat_t = treated_rows.to(torch.int64).repeat_interleave(m)
    order = torch.sort(flat_d, stable=True).indices
    taken = greedy_sweep(flat_d[order].contiguous(), flat_c[order],
                         flat_t[order], n_rows, k)
    take = torch.zeros((nt * m,), dtype=torch.bool, device=cand_dist.device)
    take[order] = taken
    return take.reshape(nt, m), order


def nnmnr(U: torch.Tensor, treatment: torch.Tensor, valid: torch.Tensor,
          k: int, caliper: float, m_candidates: Optional[int] = None,
          engine: str = "auto") -> MatchResult:
    """k:1 NNM without replacement = with-replacement candidates (m >= k
    per treated unit) + the greedy global sweep."""
    m = m_candidates or max(4 * k, 8)
    wr = nnmwr(U, treatment, valid, k=m, caliper=caliper, engine=engine)
    n = U.shape[0]
    treated_rows = torch.arange(n, device=U.device)
    take, _ = greedy_nnmnr(torch.where(wr.ok, wr.dist, BIG), wr.idx,
                           treated_rows, n, k)
    return MatchResult(idx=wr.idx, dist=wr.dist, ok=wr.ok & take,
                       treated_mask=wr.treated_mask)
