"""Average-treatment-effect estimation from decomposable group stats
(paper Eq. 1 / Eq. 4) — counterpart of :mod:`repro.core.ate`.

  tau_ATE = E_b[ E[Y|T=1, b] - E[Y|T=0, b] ]        (Eq. 4)

weighted by group probability n_b / N over the matched groups; ATT weighs
by treated counts. The per-group arithmetic follows the reference
expression by expression; the cross-group reductions go through
``sum_fn``, which here reduces an (N, S) matrix of stacked vectors in ONE
call — the online query passes the canonical chunked-sum kernel
(:func:`repro_torch.kernels.segment_stats.chunked_sums`), two launches per
estimate (the second stage needs the first stage's total).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

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
