"""Propensity-score estimation, E(x) = Pr(T=1 | X=x), and the streaming
sufficient statistics the online engine refits it from — counterpart of
:mod:`repro.core.propensity`.

Model half: masked Newton-Raphson logistic regression with ridge damping
(:func:`fit_logistic`, :func:`warm_refit`, :func:`predict_ps`,
:func:`propensity_scores`). Each Newton step takes g and H from the
``logistic_newton_terms`` kernel (one pass over X on the card) and adds
the reference's damping outside it: the reference weights its Hessian
rows by ``m p (1 - p) + 1e-6`` (``propensity.py:78``), the kernel by
``m p (1 - p)`` as the TPU kernel does, so ``1e-6 XbᵀXb`` — a constant of
the fit, one ``torch.matmul`` — is added to H here. The (d+1, d+1)
system is solved with ``torch.linalg.solve_ex``, which does not make the
host wait for an error check; ``converged`` stays a device bool.

Stream half: :class:`StreamStats` keeps exact signed moment sums of every
row column plus a bounded priority reservoir of rows, updated by every
ingest and retraction with no host read:

- moments: the signed per-column terms of a batch stacked into one
  (N, 1 + 2k) matrix and reduced by ``chunked_sums`` (one ``chunk_sums``
  launch; the reference's ``jnp.sum`` order cannot be reproduced, so the
  port pins its own and agrees with the reference within tolerance);
- reservoir: each valid row draws a threefry uniform priority equal bit
  for bit to the reference's (:mod:`repro_torch.core.prng`), and the
  ``capacity`` largest priorities of reservoir + batch survive. The
  reference's ``lax.top_k`` takes the lower index first among ties; a
  stable descending ``torch.sort`` does too (``torch.topk`` promises no
  tie order), which keeps empty slots (zero rows) ahead of invalid batch
  rows, so the reservoir equals the reference's bit for bit;
- retraction: rows are matched to reservoir slots by content-hash tags
  (u32 hashes of the f32 bit patterns, held in int64 masked to 32 bits)
  and removed multiplicity-aware, as :func:`_stream_retract` describes.

Layout: the reservoir is ONE (R, k) float32 tensor with columns in
``names`` order (one gather per update instead of k), and the moment
sums are (k,) tensors; :attr:`StreamStats.columns` and the engine's
snapshots present them per column, as the reference holds them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import groupby, prng
from repro_torch.core.keys import INVALID_HI, INVALID_LO, MASK32, sort_key
from repro_torch.data.columnar import Table
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.logistic_grad import logistic_newton_terms
from repro_torch.kernels.segment_stats import chunked_sum, chunked_sums

NEG_INF = float("-inf")


# ------------------------------------------------------------ model half
@dataclasses.dataclass(frozen=True)
class LogisticModel:
    w: torch.Tensor          # (d+1,) last entry = intercept
    mean: torch.Tensor       # (d,) standardization
    std: torch.Tensor        # (d,)
    converged: torch.Tensor  # () bool (grad-norm based)


def model_from_numpy(w, mean, std, converged,
                     device: DeviceLike = None) -> LogisticModel:
    """A model from host arrays — e.g. a reference model's parameters,
    to warm-start a refit from it."""
    dev = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return LogisticModel(w=f32(w), mean=f32(mean), std=f32(std),
                         converged=torch.tensor(bool(converged), device=dev))


def design_matrix(table: Table, features: Sequence[str]) -> torch.Tensor:
    return torch.stack([table[f].to(torch.float32) for f in features],
                       dim=-1)


def _standardize(X: torch.Tensor, valid: torch.Tensor):
    """Masked (mean, std) of the columns of X, each sum a pinned chunked
    sum, and X standardized by them."""
    w = valid.to(torch.float32)[:, None]
    tot = chunked_sums(torch.cat([w, X * w], dim=1))
    n = torch.clamp(tot[0], min=1.0)
    mean = tot[1:] / n
    var = chunked_sums(w * (X - mean) ** 2) / n
    std = torch.sqrt(torch.clamp(var, min=1e-12))
    return (X - mean) / std, mean, std


def fit_logistic(X: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
                 n_iter: int = 32, ridge: float = 1e-4,
                 init: Optional[LogisticModel] = None,
                 moments: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 ) -> LogisticModel:
    """Newton-Raphson logistic regression on valid rows.

    X: (N, d) raw features; t: (N,) binary treatment; valid: (N,) mask.
    ``init`` warm-starts from a previous model: its coefficients seed the
    iteration and its standardization is FROZEN; ``n_iter`` is then the
    refresh's step budget. ``moments`` overrides the standardization with
    an externally maintained (mean, std) — the engine's exact stream-wide
    moments for a reservoir fit."""
    X = X.to(torch.float32)
    if moments is not None:
        mean, std = moments
        Xs = (X - mean) / std
    elif init is not None:
        mean, std = init.mean, init.std
        Xs = (X - mean) / std
    else:
        Xs, mean, std = _standardize(X, valid)
    n, d = Xs.shape
    Xb = torch.cat([Xs, torch.ones((n, 1), dtype=torch.float32,
                                   device=X.device)], dim=1)
    m = valid.to(torch.float32).contiguous()
    tf = t.to(torch.float32).contiguous()
    damp = 1e-6 * (Xb.t() @ Xb) + ridge * torch.eye(
        d + 1, dtype=torch.float32, device=X.device)

    def grad(w):
        g, H = logistic_newton_terms(Xb, tf, m, w)
        return g + ridge * w, H

    w = (init.w.to(torch.float32).clone() if init is not None
         else torch.zeros((d + 1,), dtype=torch.float32, device=X.device))
    for _ in range(n_iter):
        g, H = grad(w)
        w = w - torch.linalg.solve_ex(H + damp, g).result
    # judged at the RETURNED w, as the reference does
    g_final, _ = grad(w)
    converged = (torch.linalg.vector_norm(g_final)
                 < 1e-3 * (1 + chunked_sum(m)) ** 0.5)
    return LogisticModel(w=w, mean=mean, std=std, converged=converged)


def warm_refit(model: LogisticModel, X: torch.Tensor, t: torch.Tensor,
               valid: torch.Tensor, n_iter: int = 4, ridge: float = 1e-4
               ) -> LogisticModel:
    """Online propensity refresh: resume Newton from ``model`` with a
    small step budget."""
    return fit_logistic(X, t, valid, n_iter=n_iter, ridge=ridge, init=model)


def predict_ps(model: LogisticModel, X: torch.Tensor) -> torch.Tensor:
    Xs = (X.to(torch.float32) - model.mean) / model.std
    return torch.sigmoid(Xs @ model.w[:-1] + model.w[-1])


def propensity_scores(table: Table, treatment: str,
                      features: Sequence[str], n_iter: int = 32,
                      ridge: float = 1e-4
                      ) -> Tuple[torch.Tensor, LogisticModel]:
    """Fit on the table's valid rows, predict for all rows."""
    X = design_matrix(table, features)
    model = fit_logistic(X, table[treatment], table.valid, n_iter=n_iter,
                         ridge=ridge)
    return predict_ps(model, X), model


# ----------------------------------------------------------- stream half
def _signed_moments(n, sums, sumsqs, X: torch.Tensor, valid: torch.Tensor,
                    sign: float):
    """Fold one batch (X (N, k) f32) into the moment accumulators: plain
    signed sums, so retraction (sign=-1) reverses them exactly. One
    ``chunked_sums`` over the stacked (N, 1 + 2k) terms."""
    k = X.shape[1]
    w = (valid.to(torch.float32) * sign)[:, None]
    wx = w * X
    tot = chunked_sums(torch.cat([w, wx, wx * X], dim=1))
    return n + tot[0], sums + tot[1:1 + k], sumsqs + tot[1 + k:]


def _top(priority: torch.Tensor, cap: int):
    """The ``cap`` largest priorities and their indices, ties to the lower
    index (``lax.top_k``'s order)."""
    pri, idx = torch.sort(priority, descending=True, stable=True)
    return pri[:cap], idx[:cap]


def _stream_update(res, priority, n, sums, sumsqs, X, valid, key):
    """One streamed batch into (moments, reservoir): every valid row draws
    a U(0,1) priority and the ``capacity`` largest across reservoir and
    batch survive — uniform sampling without sequential per-row state."""
    new_n, new_sums, new_sumsqs = _signed_moments(n, sums, sumsqs, X, valid,
                                                  1.0)
    u = prng.uniform(key, X.shape[0], X.device)
    pri = torch.where(valid, u, NEG_INF)
    new_pri, idx = _top(torch.cat([priority, pri]), priority.shape[0])
    new_res = torch.cat([res, X])[idx]
    return new_res, new_pri, new_n, new_sums, new_sumsqs


def _row_tags(X: torch.Tensor, alive: torch.Tensor):
    """Key tags of rows: two independent u32 content hashes over the f32
    bit patterns of every column (``propensity.py:138``), in int64 masked
    to 32 bits (a product of two u32 values wraps in int64; its low 32
    bits are still the u32 product). The first word's top bit is cleared,
    so a live tag never equals the invalid-key marker, which rows with
    ``alive=False`` get."""
    bits = X.contiguous().view(torch.int32).to(torch.int64) & MASK32
    h1, h2 = 0x811C9DC5, 0x01000193
    for j in range(X.shape[1]):
        x = bits[:, j]
        h1 = ((h1 ^ x) * 0x9E3779B1) & MASK32
        h1 = h1 ^ (h1 >> 15)
        h2 = ((h2 ^ ((x * 0x85EBCA6B) & MASK32)) * 0xC2B2AE35) & MASK32
        h2 = h2 ^ (h2 >> 13)
    h1 = h1 & 0x7FFFFFFF
    return (torch.where(alive, h1, INVALID_HI),
            torch.where(alive, h2, INVALID_LO))


def _stream_retract(res, priority, n, sums, sumsqs, X, valid):
    """Exact retraction: reverse the moments AND delete the sampled copies
    of the retracted rows from the reservoir (key-tagged deletion,
    ``propensity.py:163``). Deletion is multiplicity-aware: slot s dies
    iff its occurrence rank among same-tag live slots (in slot order) is
    below the retracted count of that tag. Removed slots are zeroed and
    the reservoir re-sorts by priority, so the surviving layout equals a
    stream that never held the removed rows. A retracted row whose copy a
    full reservoir had already displaced removes nothing."""
    new_n, new_sums, new_sumsqs = _signed_moments(n, sums, sumsqs, X, valid,
                                                  -1.0)
    cap = priority.shape[0]
    alive = priority > NEG_INF
    if X.shape[0] == 0:
        return res, priority, new_n, new_sums, new_sumsqs
    s1, s2 = _row_tags(res, alive)
    r1, r2 = _row_tags(X, valid)
    # per-tag retracted counts (segment sums over the grouped batch tags),
    # looked up per slot in the sorted group table
    g = groupby.group_by_key(r1, r2)
    cnt = groupby.segment_sums(g, valid.to(torch.float32)[:, None],
                               g.nrows)[:, 0]
    pos, found = groupby.lookup_rows_in_table(s1, s2, g.group_hi,
                                              g.group_lo)
    c = torch.where(found, cnt[pos], 0.0)
    # occurrence rank of each slot among equal-tag slots: a stable sort by
    # (s1, s2), then the distance to the run's first position
    skey, perm = torch.sort(sort_key(s1, s2), stable=True)
    iota = torch.arange(cap, device=res.device)
    head = torch.ones((cap,), dtype=torch.bool, device=res.device)
    head[1:] = skey[1:] != skey[:-1]
    rank_sorted = iota - torch.cummax(torch.where(head, iota, 0),
                                      dim=0).values
    rank = torch.empty_like(rank_sorted).scatter_(0, perm, rank_sorted)
    removed = alive & found & (rank.to(torch.float32) < c)
    new_pri, idx = _top(torch.where(removed, NEG_INF, priority), cap)
    new_res = torch.where(removed[:, None], 0.0, res)[idx]
    return new_res, new_pri, new_n, new_sums, new_sumsqs


@dataclasses.dataclass(frozen=True)
class StreamStats:
    """Sufficient statistics for streaming propensity refreshes: exact
    per-column moment sums plus a bounded uniform reservoir of rows, so
    :meth:`OnlineEngine.refresh_propensity` needs no row log. Moments
    standardize over the WHOLE stream and reverse exactly on retraction;
    the key-tagged reservoir deletes the sampled copy of every retracted
    row."""

    names: Tuple[str, ...]
    res: torch.Tensor        # (R, k) f32 reservoir rows, columns = names
    priority: torch.Tensor   # (R,) f32; -inf marks an empty slot
    n: torch.Tensor          # () f32 valid rows accumulated
    sums: torch.Tensor       # (k,) f32
    sumsqs: torch.Tensor     # (k,) f32
    seed: int = 0
    n_batches: int = 0       # host counter folded into the PRNG key

    @classmethod
    def empty(cls, names: Sequence[str], capacity: int = 8192,
              seed: int = 0, device: DeviceLike = None) -> "StreamStats":
        names = tuple(names)
        dev = resolve_device(device)
        k = len(names)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        return cls(names=names, res=zeros(capacity, k),
                   priority=torch.full((capacity,), NEG_INF,
                                       dtype=torch.float32, device=dev),
                   n=zeros(), sums=zeros(k), sumsqs=zeros(k), seed=seed)

    @property
    def capacity(self) -> int:
        return int(self.priority.shape[0])

    @property
    def columns(self) -> Dict[str, torch.Tensor]:
        """(R,) reservoir slots per column, as the reference holds them."""
        return {c: self.res[:, j] for j, c in enumerate(self.names)}

    def update(self, batch_cols: Mapping[str, torch.Tensor],
               valid: torch.Tensor, retract: bool = False) -> "StreamStats":
        X = torch.stack([batch_cols[c].to(torch.float32)
                         for c in self.names], dim=1)
        valid = valid.to(torch.bool)
        if retract:
            out = _stream_retract(self.res, self.priority, self.n, self.sums,
                                  self.sumsqs, X, valid)
        else:
            key = prng.fold_in(prng.prng_key(self.seed), self.n_batches)
            out = _stream_update(self.res, self.priority, self.n, self.sums,
                                 self.sumsqs, X, valid, key)
        res, pri, n, sums, sumsqs = out
        return dataclasses.replace(self, res=res, priority=pri, n=n,
                                   sums=sums, sumsqs=sumsqs,
                                   n_batches=self.n_batches + 1)

    def moments(self, features: Sequence[str]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact stream-wide (mean, std) per feature from the accumulators
        — the formula of :func:`_standardize` over the full row set."""
        cols = [self.names.index(f) for f in features]
        n = torch.clamp(self.n, min=1.0)
        mean = self.sums[cols] / n
        ex2 = self.sumsqs[cols] / n
        std = torch.sqrt(torch.clamp(ex2 - mean ** 2, min=1e-12))
        return mean, std

    def reservoir(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """(columns, valid-mask) of the sampled rows, fit-ready."""
        return self.columns, self.priority > NEG_INF
