"""Newton terms of masked logistic regression — the CUDA kernel's wrapper
and its plain PyTorch version.

Replaces ``repro/kernels/logistic_grad.py::logistic_newton_terms_pallas``
(with ``logistic_newton_terms_op``'s padding): for X (N, d) with the
caller's bias column, targets t, row weights m (N,) and coefficients w
(d,), one pass over X gives

    g = Xᵀ (m (σ(Xw) − t))        H = Xᵀ diag(m σ(Xw)(1 − σ(Xw))) X.

One launch on the card, no float atomics (``csrc/logistic_grad.cu``):

1. a warp per 1024-row tile computes each row's logit (ascending j),
   p = 1/(1 + exp(−z)), r = m(p − t) and s = (m p)(1 − p), and reduces
   the tile's Q = d + d(d+1)/2 terms ``r x_j`` and ``(s x_j) x_k``
   (j <= k) by the halving tree of ``chunk_sums`` into tile partials;
2. the last block by ticket adds the (n_tiles, Q) partials in
   ``chunk_sums``' order and writes g and H, H's lower triangle the
   mirror of its upper one.

The plain version writes the same arithmetic in the same order (the
per-row terms, then ``chunk_sums_plain`` over the rows and again over the
tile partials), so the two agree up to the device's ``exp``. Bound by
memory: 4d + 8 bytes per row.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_stats import CANONICAL_BLOCK, chunk_sums_plain

KERNEL = build.KERNELS["logistic_newton_terms"]
# widest design matrix the kernel takes (its C entry point refuses more)
MAX_D = 64


def _n_terms(d: int) -> int:
    return d + d * (d + 1) // 2


def _check_width(d: int) -> None:
    if not 1 <= d <= MAX_D:
        raise ValueError(f"logistic_newton_terms: d={d} outside [1, {MAX_D}]"
                         f" (the kernel's limit; the plain version keeps it "
                         f"too, so both take the same inputs)")


def _scratch_floats(n_tiles: int, d: int) -> int:
    """Floats of the kernel's scratch: the (Q, n_tiles) tile partials, the
    (groups of 1024 tiles, Q) group sums, the Q totals, then g and H."""
    q = _n_terms(d)
    return q * n_tiles + -(-n_tiles // CANONICAL_BLOCK) * q + q + d + d * d


def _upper_pairs(d: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(j, k) for j <= k in row-major upper-triangle order: the order of
    H's terms in a partials row."""
    iu = torch.triu_indices(d, d, device=device)
    return iu[0], iu[1]


@functools.lru_cache(maxsize=64)
def _mirror_index(d: int, device: torch.device) -> torch.Tensor:
    """(d, d) int64: the position of H[j, k] among H's upper-triangle
    terms, for j > k that of H[k, j]. Built once per width and device (a
    Newton fit asks for it every step)."""
    a = torch.arange(d)
    lo = torch.minimum(a[:, None], a[None, :])
    hi = torch.maximum(a[:, None], a[None, :])
    return (lo * d - lo * (lo - 1) // 2 + (hi - lo)).to(device)


def _assemble(totals: torch.Tensor, d: int) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(Q,) term sums -> (g (d,), H (d, d)) with H's lower triangle the
    mirror of its upper one."""
    return totals[:d], totals[d:][_mirror_index(d, totals.device)]


def newton_row_terms_plain(X: torch.Tensor, t: torch.Tensor,
                           m: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, Q) per-row terms: ``r x_j`` for j < d, then ``(s x_j) x_k``
    for j <= k, each rounded as the kernel rounds it."""
    n, d = X.shape
    z = torch.zeros((n,), dtype=torch.float32, device=X.device)
    for j in range(d):
        z = z + X[:, j] * w[j]
    p = 1.0 / (1.0 + torch.exp(-z))
    r = m * (p - t)
    s = m * p * (1.0 - p)
    j, k = _upper_pairs(d, X.device)
    return torch.cat([r[:, None] * X, (s[:, None] * X)[:, j] * X[:, k]],
                     dim=1)


def logistic_newton_terms_plain(X: torch.Tensor, t: torch.Tensor,
                                m: torch.Tensor, w: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """X (N, d) f32, t and m (N,) f32, w (d,) f32 -> (g (d,), H (d, d)):
    the per-row terms summed per 1024-row tile by the halving tree, the
    tile partials combined by :func:`chunk_sums_plain`."""
    _check_width(X.shape[1])
    partials, _ = chunk_sums_plain(newton_row_terms_plain(X, t, m, w))
    return _assemble(chunk_sums_plain(partials)[1], X.shape[1])


def logistic_newton_terms(X: torch.Tensor, t: torch.Tensor, m: torch.Tensor,
                          w: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Same contract as :func:`logistic_newton_terms_plain`. CPU tensors
    take the plain version; CUDA tensors launch the kernel once (or
    raise): g and H are views of its scratch. Its last block combines by
    a ticket on the counter of the current stream (:func:`build.ticket`),
    which the stream serialises between calls."""
    n, d = X.shape
    _check_width(d)
    if X.device.type == "cpu":
        return logistic_newton_terms_plain(X, t, m, w)
    dev = build.require_cuda("logistic_newton_terms", X, t, m, w)
    build.check("logistic_newton_terms X", X, torch.float32, (n, d))
    build.check("logistic_newton_terms t", t, torch.float32, (n,))
    build.check("logistic_newton_terms m", m, torch.float32, (n,))
    build.check("logistic_newton_terms w", w, torch.float32, (d,))
    n_tiles = max(1, -(-n // CANONICAL_BLOCK))
    scratch = torch.empty((_scratch_floats(n_tiles, d),),
                          dtype=torch.float32, device=dev)
    KERNEL.launch(dev, X.data_ptr(), t.data_ptr(), m.data_ptr(),
                  w.data_ptr(), scratch.data_ptr(), n, d, n_tiles)
    out = scratch[-(d + d * d):]
    return out[:d], out[d:].view(d, d)
