"""Distance measures for matching (paper Fig. 1) — counterpart of
:mod:`repro.core.distance`.

- Propensity-score distance |E(x_i) - E(x_j)| (1-D).
- Mahalanobis distance (x_i - x_j)' Sigma^{-1} (x_i - x_j): with
  L = chol(Sigma^{-1}), d(i, j) = ||L^T x_i - L^T x_j||^2, so a one-time
  feature rotation turns it into squared Euclidean distance, the only
  distance the k-NN kernel computes.
- Coarsened distance (0 in the same coarsened cell, inf otherwise) is CEM
  (:mod:`repro_torch.core.cem`).

The covariance, inverse and Cholesky factor are small library calls
(``torch.linalg``), as the reference leaves them to ``jnp.linalg``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.data.columnar import Table


def masked_covariance(X: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    w = valid.to(torch.float32)[:, None]
    n = torch.clamp(w.sum(), min=2.0)
    mean = (X * w).sum(dim=0) / n
    Xc = (X - mean) * w
    return Xc.T @ Xc / (n - 1.0)


def mahalanobis_transform(X: torch.Tensor, valid: torch.Tensor,
                          ridge: float = 1e-6) -> torch.Tensor:
    """Rotate features so Euclidean distance == Mahalanobis distance."""
    d = X.shape[1]
    sigma = masked_covariance(X, valid) + ridge * torch.eye(
        d, dtype=torch.float32, device=X.device)
    L = torch.linalg.cholesky(torch.linalg.inv(sigma))
    return X.to(torch.float32) @ L


def features(table: Table, names: Sequence[str]) -> torch.Tensor:
    return torch.stack([table[n].to(torch.float32) for n in names], dim=-1)


def pairwise_sqdist(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """(n, d) x (m, d) -> (n, m) squared Euclidean distances via matmul."""
    un = (U * U).sum(dim=1, keepdim=True)
    vn = (V * V).sum(dim=1, keepdim=True)
    return torch.clamp(un + vn.T - 2.0 * (U @ V.T), min=0.0)


def ps_distance_features(ps: torch.Tensor) -> torch.Tensor:
    """Propensity distance as 1-D Euclidean features."""
    return ps.to(torch.float32)[:, None]
