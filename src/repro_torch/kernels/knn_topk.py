"""k nearest valid controls per query (squared Euclidean distance): the
CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``repro/kernels/knn_topk.py::knn_topk_pallas`` (with
``knn_topk_op``'s padding), under the contract of
``repro/core/matching.py::knn_quadratic``, which the reference's matching
runs: for Q (Nq, d), C (Nc, d) f32 and c_valid (Nc,) bool,

    d2[i, j] = max((|q_i|² + |c_j|²) − 2 q_i·c_j, 0)

and per query the k smallest (d2, idx) in lexicographic order over the
valid controls — ties go to the lower index — with (BIG, -1) in every slot
that no valid control fills. (The Pallas kernel re-picks a taken position
in such slots, ``knn_topk_ref`` returns invalid columns there; the port
keeps ``knn_quadratic``'s convention.)

The norms and the dot product add their d terms in ascending column
order, each product and sum rounded on its own, in the kernel
(``csrc/knn_topk.cu``) and in the plain version below (elementwise tensor
ops, a loop over tiles of queries x controls), so the two agree bit for
bit. The kernel gives each thread R queries (:func:`queries_per_thread`)
and, when the query blocks alone would not fill the card, splits the
controls into S contiguous ranges whose partial top-k lists a second
kernel merges (:func:`plan` chooses R and S; the merge's result is the
same for any S). The plain version merges each tile into the running
top-k with ``torch.topk`` over int64 keys ``(bits(d2) << 32) | (idx + 1)``:
the bit pattern of a non-negative f32 orders as its value, so the keys
order as (d2, idx) lexicographically and are distinct — no tie is left to
the library. A filler (BIG, -1) has the key ``bits(BIG) << 32``, below every
control that is invalid or not below BIG (those keep ``d2 = BIG`` and
their index), so they never displace it.

k is at most 16 and d at most 64 (the kernel's registers); both versions
raise above that.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build

KERNEL = build.KERNELS["knn_topk"]
BIG = 3.4e38
MAX_K = 16
MAX_D = 64
# the plain version's tiles: queries x controls per step (small enough
# that a step's temporaries stay in a CPU's caches)
PLAIN_QBLOCK = 1024
PLAIN_BLOCK = 2048
# the kernel's threads a block and controls a tile (csrc/knn_topk.cu)
THREADS = 128
TILE = 128
# a control range holds at least MIN_RANGE controls (unless there are
# fewer)
MIN_RANGE = 1024


def _check(k: int, d: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_topk: k={k} outside [1, {MAX_K}] (the "
                         f"kernel's limit; the plain version keeps it too)")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"knn_topk: d={d} outside [1, {MAX_D}] (the "
                         f"kernel's limit; the plain version keeps it too)")


def queries_per_thread(k: int, d: int) -> int:
    """R, the queries each thread of the kernel holds in registers: 4 for
    K = 1 and 8, 2 for K = 16 (K = k rounded up to 1, 8 or 16), 1 above
    width 8."""
    if d > 8:
        return 1
    return 2 if k > 8 else 4


def plan(nq: int, nc: int, k: int, d: int, slots: int
         ) -> Tuple[int, int, int, int]:
    """The kernel's launch: (R, query blocks, S control ranges, rows a
    range). ``slots`` is how many blocks of the partial kernel the card
    holds at once (:func:`resident_blocks`). While the query blocks number
    fewer, the controls are split into as many ranges as keep every block
    resident (one wave: no tail of lone blocks); a range is whole tiles,
    at least MIN_RANGE controls unless there are fewer, and no range is
    empty."""
    r = queries_per_thread(k, d)
    qblocks = -(-nq // (THREADS * r))
    s = max(1, min(slots // qblocks, nc // MIN_RANGE))
    per = -(-nc // s)
    span = max(TILE, -(-per // TILE) * TILE)
    return r, qblocks, max(1, -(-nc // span)), span


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def resident_blocks(index: int, k: int, d: int) -> int:
    """Blocks of the partial kernel for (k, d) that CUDA device ``index``
    holds at once: its occupancy per SM (from the CUDA runtime) times its
    SMs."""
    per_sm = KERNEL.function("knn_topk_blocks_per_sm",
                             [ctypes.c_int, ctypes.c_int])
    with torch.cuda.device(index):
        return max(1, per_sm(d, k)) * sm_count(index)


def _sq_norms(X: torch.Tensor) -> torch.Tensor:
    """(N,) |x|² with the d terms added in ascending column order."""
    n = X[:, 0] * X[:, 0]
    for j in range(1, X.shape[1]):
        n = n + X[:, j] * X[:, j]
    return n


def knn_topk_plain(Q: torch.Tensor, C: torch.Tensor, c_valid: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Q (Nq, d) f32, C (Nc, d) f32, c_valid (Nc,) bool -> (d2 (Nq, k) f32,
    idx (Nq, k) int64), as the module docstring states."""
    nq, d = Q.shape
    _check(k, d)
    dev = Q.device
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    filler = big.view(torch.int32).to(torch.int64) << 32
    qn = _sq_norms(Q)
    cn = _sq_norms(C)
    run = filler.expand(nq, k).clone()
    for q0 in range(0, nq, PLAIN_QBLOCK):
        Qb, qnb = Q[q0:q0 + PLAIN_QBLOCK], qn[q0:q0 + PLAIN_QBLOCK, None]
        rb = run[q0:q0 + PLAIN_QBLOCK]
        for s in range(0, C.shape[0], PLAIN_BLOCK):
            Cb = C[s:s + PLAIN_BLOCK]
            nb = Cb.shape[0]
            dot = Qb[:, 0:1] * Cb[:, 0][None, :]
            for j in range(1, d):
                dot = dot + Qb[:, j:j + 1] * Cb[:, j][None, :]
            x = torch.clamp_min((qnb + cn[None, s:s + nb]) - 2.0 * dot, 0.0)
            x = torch.where(c_valid[None, s:s + nb] & (x < big), x, big)
            idx = torch.arange(s + 1, s + 1 + nb, device=dev)
            keys = (x.view(torch.int32).to(torch.int64) << 32) | idx[None, :]
            rb = torch.topk(torch.cat([rb, keys], dim=1), k, dim=1,
                            largest=False, sorted=True).values
        run[q0:q0 + PLAIN_QBLOCK] = rb
    d2 = (run >> 32).to(torch.int32).view(torch.float32)
    return d2, (run & 0xFFFFFFFF) - 1


def knn_topk(Q: torch.Tensor, C: torch.Tensor, c_valid: torch.Tensor,
             k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`knn_topk_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    nq, d = Q.shape
    _check(k, d)
    if Q.device.type == "cpu":
        return knn_topk_plain(Q, C, c_valid, k)
    dev = build.require_cuda("knn_topk", Q, C, c_valid)
    nc = C.shape[0]
    build.check("knn_topk Q", Q, torch.float32, (nq, d))
    build.check("knn_topk C", C, torch.float32, (nc, d))
    build.check("knn_topk c_valid", c_valid, torch.bool, (nc,))
    if nc >= 1 << 31:
        raise ValueError(f"knn_topk: {nc} controls (int32 indices)")
    d2 = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int64, device=dev)
    if nq:
        r, _, s, span = plan(nq, nc, k, d, resident_blocks(dev.index, k, d))
        part_d = part_i = None
        if s > 1:
            pd = torch.empty((s * k * nq,), dtype=torch.float32, device=dev)
            pi = torch.empty((s * k * nq,), dtype=torch.int32, device=dev)
            part_d, part_i = pd.data_ptr(), pi.data_ptr()
        KERNEL.launch(dev, Q.data_ptr(), C.data_ptr(), c_valid.data_ptr(),
                      d2.data_ptr(), idx.data_ptr(), part_d, part_i, nq, nc,
                      d, k, r, s, span)
    return d2, idx


def knn_topk_op(Q: torch.Tensor, C: torch.Tensor, c_valid: torch.Tensor,
                k: int, caliper: float = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN reported as Euclidean distances, with an optional caliper on
    them (``knn_topk_op`` of the reference): slots beyond the caliper hold
    BIG. An unfilled slot's distance is sqrt(BIG) = 1.84e19 before the
    caliper, as in the reference."""
    d2, idx = knn_topk(Q.to(torch.float32).contiguous(),
                       C.to(torch.float32).contiguous(),
                       c_valid.to(torch.bool).contiguous(), k)
    # the square root in f64, rounded once to f32: the correctly rounded
    # f32 root (53 >= 2 * 24 + 2 bits), the same bits on every device
    dist = torch.sqrt(d2.to(torch.float64)).to(torch.float32)
    if caliper is not None:
        dist = torch.where(dist <= caliper, dist, BIG)
    return dist, idx
