"""Average-treatment-effect estimation (paper Eq. 1 / Eq. 4) — counterpart
of :mod:`repro.core.ate`.

  tau_ATE = E_b[ E[Y|T=1, b] - E[Y|T=0, b] ]        (Eq. 4)

weighted by group probability n_b / N over the matched groups; ATT weighs
by treated counts. The per-group arithmetic follows the reference
expression by expression; the cross-group reductions go through
``sum_fn``, which here reduces an (N, S) matrix of stacked vectors in ONE
call — the online query passes the canonical chunked-sum kernel
(:func:`repro_torch.kernels.segment_stats.chunked_sums`), two launches per
estimate (the second stage needs the first stage's total). The offline
estimators below reduce through the same kernel, so their answers on the
card and on the CPU are the same sums in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import groupby
from repro_torch.core.cem import CEMGroups
from repro_torch.kernels.segment_stats import chunked_sums

SumFn = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ATEEstimate:
    """Both estimands of one causal query, plus match diagnostics.

    ``state_version`` is the snapshot tag of online estimates (-1 for
    estimates with no versioned state). The online engine returns host
    (numpy) scalars, like the reference's ``device_get``."""

    ate: object
    att: object
    n_matched_treated: object
    n_matched_control: object
    n_groups: object
    variance: object
    state_version: int = -1


def estimate_ate_from_stats(keep: torch.Tensor, n_treated: torch.Tensor,
                            n_control: torch.Tensor, sum_y_t: torch.Tensor,
                            sum_y_c: torch.Tensor,
                            sum_yy_t: torch.Tensor = None,
                            sum_yy_c: torch.Tensor = None, *,
                            sum_fn: SumFn) -> ATEEstimate:
    """ATE/ATT straight from per-group stats (no row access); with per-arm
    second moments the Neyman within-group variance is included, else 0.
    Returns tensors (0-d) on the stats' device."""
    nt = torch.where(keep, n_treated, 0.0)
    nc = torch.where(keep, n_control, 0.0)
    mean_t = torch.where(nt > 0, sum_y_t / torch.clamp(nt, min=1e-9), 0.0)
    mean_c = torch.where(nc > 0, sum_y_c / torch.clamp(nc, min=1e-9), 0.0)
    diff = mean_t - mean_c
    n_b = nt + nc
    first = sum_fn(torch.stack([
        n_b, nt, nc,
        torch.where(keep, n_b * diff, 0.0),
        torch.where(keep, nt * diff, 0.0)], dim=1))
    n_tot = torch.clamp(first[0], min=1e-9)
    ate = first[3] / n_tot
    att = first[4] / torch.clamp(first[1], min=1e-9)
    if sum_yy_t is None or sum_yy_c is None:
        var = torch.zeros((), dtype=torch.float32, device=keep.device)
    else:
        var_t = sum_yy_t / torch.clamp(nt, min=1e-9) - mean_t ** 2
        var_c = sum_yy_c / torch.clamp(nc, min=1e-9) - mean_c ** 2
        se2_b = (var_t / torch.clamp(nt, min=1.0)
                 + var_c / torch.clamp(nc, min=1.0))
        var = sum_fn(torch.where(keep, (n_b / n_tot) ** 2 * se2_b,
                                 0.0)[:, None])[0]
    return ATEEstimate(ate=ate, att=att, n_matched_treated=first[1],
                       n_matched_control=first[2],
                       n_groups=keep.sum(dtype=torch.int32), variance=var)


def estimate_ate(groups: CEMGroups, y: torch.Tensor = None,
                 treatment: torch.Tensor = None,
                 matched_valid: torch.Tensor = None) -> ATEEstimate:
    """ATE/ATT from group stats. If (y, treatment, matched_valid) are
    given, the Neyman within-group variance is included (else 0): the
    per-arm second moments are summed per group by the segment-sum kernel
    over all N group ids. Returns 0-d tensors on the groups' device."""
    yy_t = yy_c = None
    if y is not None:
        w = matched_valid.to(torch.float32)
        t = treatment.to(torch.float32) * w
        c = (1.0 - treatment.to(torch.float32)) * w
        yf = y.to(torch.float32)
        g = groups.grouping
        yy = groupby.segment_sums(g, torch.stack([t * yf * yf, c * yf * yf],
                                                 dim=1), g.nrows)
        yy_t, yy_c = yy[:, 0], yy[:, 1]
    return estimate_ate_from_stats(groups.keep, groups.n_treated,
                                   groups.n_control, groups.sum_y_t,
                                   groups.sum_y_c, yy_t, yy_c,
                                   sum_fn=chunked_sums)


def cem_weights(groups: CEMGroups, treatment: torch.Tensor,
                matched_valid: torch.Tensor) -> torch.Tensor:
    """Per-unit CEM weights (Iacus-King-Porro): treated units weight 1;
    control units in group b weight (n_t_b / n_c_b) * (N_c / N_t)."""
    g = groups.grouping
    nt_rows = groupby.broadcast_to_rows(g, groups.n_treated)
    nc_rows = groupby.broadcast_to_rows(g, groups.n_control)
    n_t, n_c = groups.matched_counts()
    w_control = ((nt_rows / torch.clamp(nc_rows, min=1e-9))
                 * (n_c / torch.clamp(n_t, min=1e-9)))
    w = torch.where(treatment.to(torch.float32) > 0, 1.0, w_control)
    return torch.where(matched_valid, w, 0.0)


def difference_in_means(y: torch.Tensor, treatment: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Naive (confounded) estimator E[Y|T=1] - E[Y|T=0] — Eq. 2 applied
    without balancing; the paper's cautionary baseline."""
    w = valid.to(torch.float32)
    t = treatment.to(torch.float32) * w
    c = (1.0 - treatment.to(torch.float32)) * w
    yf = y.to(torch.float32)
    s = chunked_sums(torch.stack([t * yf, t, c * yf, c], dim=1))
    return s[0] / torch.clamp(s[1], min=1e-9) - s[2] / torch.clamp(s[3],
                                                                   min=1e-9)
