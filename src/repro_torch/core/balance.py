"""Covariate-balance diagnostics (paper Eq. 5) — counterpart of
:mod:`repro.core.balance`.

AWMD(x) = E_b[ | E[x | T=1, b] - E[x | T=0, b] | ], group-probability
weighted over retained groups — 0 for perfectly balanced groups (Eq. 3).
The "raw data" imbalance is the same quantity with a single global group.
Per-group sums go through the segment-sum kernel over all N group ids and
the cross-group and cross-row sums through the canonical chunked-sum
kernel, every covariate in one launch.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from repro_torch.core import groupby
from repro_torch.core.cem import CEMGroups
from repro_torch.kernels.segment_stats import chunked_sums


def _arms(treatment: torch.Tensor, valid: torch.Tensor):
    w = valid.to(torch.float32)
    t = treatment.to(torch.float32) * w
    return t, (1.0 - treatment.to(torch.float32)) * w


def awmd(groups: CEMGroups, covariates: Mapping[str, torch.Tensor],
         treatment: torch.Tensor, matched_valid: torch.Tensor
         ) -> Dict[str, torch.Tensor]:
    """Absolute weighted mean difference per covariate over matched
    groups. Returns {name: 0-d tensor}."""
    g = groups.grouping
    t, c = _arms(treatment, matched_valid)
    cols = []
    for x in covariates.values():
        xf = x.to(torch.float32)
        cols += [t * xf, c * xf]
    sums = groupby.segment_sums(g, torch.stack(cols, dim=1), g.nrows)
    nt = torch.where(groups.keep, groups.n_treated, 0.0)
    nc = torch.where(groups.keep, groups.n_control, 0.0)
    n_b = nt + nc
    terms = [n_b]
    for j in range(len(covariates)):
        mean_t = sums[:, 2 * j] / torch.clamp(nt, min=1e-9)
        mean_c = sums[:, 2 * j + 1] / torch.clamp(nc, min=1e-9)
        terms.append(torch.where(groups.keep,
                                 n_b * torch.abs(mean_t - mean_c), 0.0))
    tot = chunked_sums(torch.stack(terms, dim=1))
    n_tot = torch.clamp(tot[0], min=1e-9)
    return {name: tot[1 + j] / n_tot for j, name in enumerate(covariates)}


def raw_imbalance(covariates: Mapping[str, torch.Tensor],
                  treatment: torch.Tensor, valid: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """AWMD with one global group: |E[x|T=1] - E[x|T=0]| on the raw
    data."""
    t, c = _arms(treatment, valid)
    cols = [t, c]
    for x in covariates.values():
        xf = x.to(torch.float32)
        cols += [t * xf, c * xf]
    s = chunked_sums(torch.stack(cols, dim=1))
    nt = torch.clamp(s[0], min=1e-9)
    nc = torch.clamp(s[1], min=1e-9)
    return {name: torch.abs(s[2 + 2 * j] / nt - s[3 + 2 * j] / nc)
            for j, name in enumerate(covariates)}
