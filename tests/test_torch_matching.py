"""The port's offline matching path (``repro_torch.core.matching``,
``distance``, ``cem``, ``ate``, ``balance``, ``subclassification`` and the
k-NN and greedy-sweep kernels' plain versions) against the reference on
the CPU: the same numpy inputs, made from seeds, go through ``repro`` (JAX
on the CPU; its Pallas k-NN kernel in interpret mode) and ``repro_torch``
(``device="cpu"``: the kernels' plain versions).

Tolerances (stated once, used everywhere):

- keys, group ids, masks, counts, matched indices, ``ok``, the taken set
  and the sweep order: exact. With integer-valued features every squared
  distance is exact in f32, so (d2, idx) are exact on every slot too,
  unfilled ones included: (BIG, -1), or sqrt(BIG) = 1.84e19 after the
  square root.
- k-NN distances on normal features: rtol 1e-3 / atol 3e-3 (the reference
  tests' rule: f32 cancellation in |q|² + |c|² − 2q·c); indices where the
  float64 distances leave a clear margin (1e-3 in d2) around the slot.
- float sums (group sums of y, estimates, AWMD, ATT): rtol 1e-5 (atol
  1e-5); the Neyman variance rtol 1e-4. The port adds in pinned tree and
  chunk orders, XLA in its own.
- Mahalanobis rotation and covariance: rtol 1e-4 / atol 1e-4 (f32 LAPACK
  inverse and Cholesky in two libraries).
- propensity models: rel 1e-4, as ``tests/test_torch_propensity.py``;
  downstream of the fit both packages get the same scores.

Few test items on purpose: see ``tests/test_torch_kernels.py``. The
exception is section (b2), step-by-step emulations of the sweep and k-NN
kernels' designs held bit for bit against their plain versions: numpy
and torch only, no reference program compiled, one parametrised case
each (a few seconds in all).
"""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from repro.core import ate as jate
from repro.core import balance as jbal
from repro.core import distance as jdist
from repro.core import matching as jm
from repro.core import oracle
from repro.core import propensity as jprop
from repro.core import subclassification as jsub
from repro.core.coarsen import CoarsenSpec as JSpec
from repro.core.coarsen import coarsen as jcoarsen
from repro.core.coarsen import coarsen_columns as jcoarsen_columns
from repro.data import flightgen as jflightgen
from repro.data.columnar import Table as JTable
from repro.kernels.ops import knn_topk_op as j_knn_op

BIG = 3.4e38
# ``repro.core`` and ``repro_torch.core`` export the function ``cem``,
# which hides the module of the same name from ``from ... import``
jcem = importlib.import_module("repro.core.cem")


def _t(a):
    import torch
    return torch.from_numpy(np.array(a))


def _np(x):
    import torch
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _close(a, b, rtol=1e-5, atol=1e-5, msg=""):
    np.testing.assert_allclose(_np(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.fixture(autouse=True)
def _release_compiled_programs():
    """Drop the worker's compiled XLA programs before and after each test
    (see the module docstring of ``tests/test_torch_kernels.py``)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _tables(cols, valid):
    from repro_torch.data.columnar import Table
    return (JTable.from_numpy(cols, valid),
            Table.from_numpy(cols, valid, device="cpu"))


# ------------------------------------------------------------------ (a) knn
def test_knn_topk_matches_knn_quadratic_and_the_pallas_op():
    """``knn_quadratic`` / ``knn_topk`` of the port against the
    reference's ``knn_quadratic`` and its Pallas ``knn_topk_op``."""
    from repro_torch.core import matching as tm
    from repro_torch.kernels import knn_topk as tk
    rng = np.random.default_rng(0)
    # (nq, nc, d, k, caliper, share of valid controls): all invalid;
    # fewer valid than k; exact ties (integer features in a small range);
    # a caliper; ragged last tiles of the plain loop
    cases = [(200, 300, 3, 4, 1e30, 0.0), (256, 512, 2, 8, 1e30, 0.01),
             (300, 1024, 3, 3, 1e30, 0.5), (240, 700, 5, 16, 4.0, 0.6),
             (tk.PLAIN_QBLOCK + 76, tk.PLAIN_BLOCK + 37, 1, 2, np.inf, 0.2)]
    for nq, nc, d, k, caliper, share in cases:
        Q = rng.integers(-4, 5, (nq, d)).astype(np.float32)
        C = rng.integers(-4, 5, (nc, d)).astype(np.float32)
        v = rng.random(nc) < share
        jd, ji = jm.knn_quadratic(jnp.asarray(Q), jnp.asarray(C),
                                  jnp.asarray(v), k, caliper, block=256)
        td, ti = tm.knn_quadratic(_t(Q), _t(C), _t(v), k, caliper)
        case = (nq, nc, d, k, caliper, share)
        assert np.array_equal(_bits(td.numpy()), _bits(jd)), case
        assert np.array_equal(ti.numpy(), np.asarray(ji)), case
        n_valid = int(v.sum())
        if n_valid < k:      # the unfilled slots: (BIG, -1) before the
            # square root, sqrt(BIG) = 1.84e19 after it (within the caliper
            # 1e30), BIG beyond a caliper
            d2, i2 = tk.knn_topk(_t(Q), _t(C), _t(v), k)
            assert (d2.numpy()[:, n_valid:] == np.float32(BIG)).all()
            assert (i2.numpy()[:, n_valid:] == -1).all()
            want = np.sqrt(np.float32(BIG)) if caliper > 2e19 else BIG
            assert (td.numpy()[:, n_valid:] == np.float32(want)).all()
        # the Pallas op (interpret mode) on the slots it fills
        if nc <= 1024:
            pd, pi = j_knn_op(jnp.asarray(Q), jnp.asarray(C),
                              jnp.asarray(v.astype(np.int32)), k)
            od, oi = tk.knn_topk_op(_t(Q), _t(C), _t(v), k)
            pd, pi = np.asarray(pd), np.asarray(pi)
            filled = pd < 1e19
            assert np.array_equal(_bits(od.numpy()[filled]),
                                  _bits(pd[filled])), case
            assert np.array_equal(oi.numpy()[filled], pi[filled]), case
    # normal features: distances within tolerance, indices where the
    # float64 distances leave a clear margin around the slot
    nq, nc, d, k = 400, 900, 3, 5
    Q = rng.normal(0, 1, (nq, d)).astype(np.float32)
    C = rng.normal(0, 1, (nc, d)).astype(np.float32)
    v = rng.random(nc) < 0.7
    jd, ji = jm.knn_quadratic(jnp.asarray(Q), jnp.asarray(C),
                              jnp.asarray(v), k, 2.0, block=128)
    td, ti = tm.knn_quadratic(_t(Q), _t(C), _t(v), k, 2.0)
    jd, ji, td, ti = map(np.asarray, (jd, ji, td.numpy(), ti.numpy()))
    inside = jd < 2.0 - 1e-2
    np.testing.assert_allclose(td[inside], jd[inside], rtol=1e-3, atol=3e-3)
    D = ((Q.astype(np.float64)[:, None, :] - C[None, :, :]) ** 2).sum(-1)
    D = np.where(v[None, :], D, np.inf)
    srt = np.sort(D, axis=1)[:, :k + 1]
    want = np.argsort(D, axis=1, kind="stable")[:, :k]
    gap = np.diff(srt, axis=1)
    clear = np.ones((nq, k), bool)
    clear[:, 1:] &= gap[:, :k - 1] > 1e-3
    clear &= gap[:, :k] > 1e-3
    clear &= np.sqrt(srt[:, :k]) < 2.0 - 1e-2
    assert clear.mean() > 0.9
    assert np.array_equal(ti[clear], want[clear])
    assert np.array_equal(ji[clear], want[clear])
    # the limits the kernel sets, kept by the plain version
    for kk, dd in ((tk.MAX_K + 1, 2), (2, tk.MAX_D + 1)):
        with pytest.raises(ValueError, match="limit"):
            tk.knn_topk(_t(np.zeros((3, dd), np.float32)),
                        _t(np.zeros((4, dd), np.float32)),
                        _t(np.ones(4, bool)), kk)


# --------------------------------------------------------------- (b) sweep
def test_greedy_nnmnr_takes_the_reference_set():
    """``greedy_nnmnr`` fed the same numpy candidates in both packages:
    the same taken set and sweep order; the invariants and total distance
    of ``oracle.greedy_match_oracle``."""
    from repro_torch.core import matching as tm
    from repro_torch.kernels import greedy_sweep as gs
    rng = np.random.default_rng(11)
    for nt, m, n_rows, k, quantum in ((20, 4, 100, 1, 0.0),
                                      (300, 8, 400, 2, 0.05),
                                      (500, 12, 640, 3, 0.0)):
        dist = rng.random((nt, m)).astype(np.float32)
        if quantum:          # equal distances: the stable order decides
            dist = (np.round(dist / quantum) * quantum).astype(np.float32)
        dist = np.where(rng.random((nt, m)) < 0.2, np.float32(BIG), dist)
        idx = rng.integers(0, n_rows, (nt, m)).astype(np.int32)
        idx[dist >= BIG] = -1
        rows = rng.permutation(n_rows)[:nt].astype(np.int32)
        jtake, jorder = jm.greedy_nnmnr(jnp.asarray(dist), jnp.asarray(idx),
                                        jnp.asarray(rows), n_rows, k=k)
        ttake, torder = tm.greedy_nnmnr(_t(dist), _t(idx), _t(rows), n_rows,
                                        k)
        assert np.array_equal(ttake.numpy(), np.asarray(jtake))
        assert np.array_equal(torder.numpy(), np.asarray(jorder))
        got = ttake.numpy()
        used = idx[got]
        assert len(used) == len(np.unique(used))
        assert np.bincount(np.repeat(rows, m)[got.reshape(-1)],
                           minlength=n_rows).max() <= k
        if not quantum:      # the oracle breaks ties by (d, control)
            edges = [(float(dist[i, j]) if dist[i, j] < BIG else np.inf,
                      int(idx[i, j]), int(rows[i]))
                     for i in range(nt) for j in range(m)]
            want = oracle.greedy_match_oracle(edges, n_rows, k=k)
            assert got.sum() == len(want)
            np.testing.assert_allclose(dist[got].astype(np.float64).sum(),
                                       sum(e[0] for e in want), rtol=1e-5)
        # the sweep's plain version on the sorted edges, directly
        o = torder.numpy()
        flat_t = np.repeat(rows, m).astype(np.int64)
        direct = gs.greedy_sweep(_t(dist.reshape(-1)[o]),
                                 _t(idx.reshape(-1)[o].astype(np.int64)),
                                 _t(flat_t[o]), n_rows, k)
        assert np.array_equal(direct.numpy(), got.reshape(-1)[o])


# ------------------------------------- (b2) the kernels' designs, emulated
# csrc/greedy_sweep.cu: compaction tile, edges a warp ballots over, blocks
# at most, edges a staged chunk; csrc/knn_topk.cu: threads a block and
# controls a tile
SWEEP_TILE, SWEEP_MAX_BLOCKS, SWEEP_CHUNK = 4096, 4096, 1024
KNN_THREADS, KNN_TILE = 128, 128


def _emulate_compaction(d, tile, max_blocks):
    """sweep_count_kernel + sweep_compact_kernel: blocks of whole tiles;
    each block's count of edges below BIG; per block, the counts of the
    blocks before it, then per tile the eight warps' ballots of 32 edges
    (a warp's edges a contiguous eighth of the tile), each flagged edge
    written at the warp's offset + its rank in the ballot. Returns the
    compacted edge indices (and checks the count the last block writes)."""
    e = d.shape[0]
    below = d < np.float32(BIG)
    tiles = -(-e // tile)
    span = -(-tiles // max_blocks) * tile
    blocks = -(-e // span)
    counts = [int(below[b * span:(b + 1) * span].sum())
              for b in range(blocks)]
    out = np.full(int(below.sum()), -1, np.int64)
    warp_edges = tile // 8
    base = 0
    for b in range(blocks):
        base = sum(counts[:b])
        lo, hi = b * span, min((b + 1) * span, e)
        for t0 in range(lo, hi, tile):
            ballots, mine = [], []
            for w in range(8):
                w0 = t0 + w * warp_edges
                bw = []
                for j in range(0, warp_edges, 32):
                    ids = w0 + j + np.arange(32)
                    flag = (ids < hi) & below[np.clip(ids, 0, e - 1)]
                    bw.append((ids, flag))
                ballots.append(bw)
                mine.append(sum(int(f.sum()) for _, f in bw))
            for w in range(8):
                off = base + sum(mine[:w])
                for ids, flag in ballots[w]:
                    rank = np.cumsum(flag) - flag
                    out[off + rank[flag]] = ids[flag]
                    off += int(flag.sum())
            base += sum(mine)
    assert base == out.shape[0] and (out >= 0).all()
    return out


def _emulate_sweep(d, c, t, n_rows, k, tile=SWEEP_TILE,
                   max_blocks=SWEEP_MAX_BLOCKS, chunk=SWEEP_CHUNK):
    """The sweep kernels step by step: the compaction; then chunk after
    chunk of ``chunk`` compacted edges, staged (clipped (c, t) and the edge
    index), walked in order by one thread with the state as the kernel
    keeps it: the used controls as bits in 32-bit words, a count per
    treated unit."""
    e = d.shape[0]
    inputs = _emulate_compaction(d, tile, max_blocks)
    used = np.zeros(-(-n_rows // 32), np.uint32)
    cnt = np.zeros(n_rows, np.int64)
    taken = np.zeros(e, bool)
    for lo in range(0, inputs.shape[0], chunk):
        ids = inputs[lo:lo + chunk]
        staged = zip(np.clip(c[ids], 0, n_rows - 1).tolist(),
                     np.clip(t[ids], 0, n_rows - 1).tolist(), ids.tolist())
        for ci, ti, ei in staged:
            bit = np.uint32(1 << (ci & 31))
            if not used[ci >> 5] & bit and cnt[ti] < k:
                used[ci >> 5] |= bit
                cnt[ti] += 1
                taken[ei] = True
    return taken


def _sweep_edges(case, rng):
    """Edge sets: unsorted with NaN and out-of-range indices, sorted with
    ties, none below BIG, all below BIG, and few distinct indices (many
    edges for each control and unit)."""
    n, n_rows = 3000, 500
    d = rng.random(n).astype(np.float32)
    c = rng.integers(-3, n_rows + 3, n).astype(np.int64)
    t = rng.integers(-2, n_rows + 2, n).astype(np.int64)
    if case == "unsorted":
        d[rng.random(n) < 0.5] = np.float32(BIG)
        d[rng.random(n) < 0.05] = np.nan
        d[rng.random(n) < 0.05] = np.inf
    elif case == "sorted_ties":
        d = np.round(d * 20).astype(np.float32) / np.float32(20)
        d[rng.random(n) < 0.3] = np.float32(BIG)
        d = np.sort(d, kind="stable")
    elif case == "none_below":
        d[:] = np.float32(BIG)
        d[::7] = np.nan
    elif case == "all_below":
        d = np.sort(d, kind="stable")
    elif case == "collisions":
        c = rng.integers(0, 12, n).astype(np.int64)
        t = rng.integers(0, 9, n).astype(np.int64)
        d[rng.random(n) < 0.1] = np.float32(BIG)
    elif case == "one_edge":
        d, c, t = d[:1], c[:1], t[:1]
    return d, c, t, n_rows


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("case", ["unsorted", "sorted_ties", "none_below",
                                  "all_below", "collisions", "one_edge"])
def test_greedy_sweep_design_takes_the_plain_set(case, k):
    """The compaction and the staged one-thread sweep of
    ``csrc/greedy_sweep.cu``, emulated step by step, at the kernel's tile,
    block cap and chunk and at small ones (several blocks of several
    tiles, chunks of 64), bit for bit against ``greedy_sweep_plain``."""
    from repro_torch.kernels import greedy_sweep as gs
    rng = np.random.default_rng(len(case) * 10 + k)
    d, c, t, n_rows = _sweep_edges(case, rng)
    want = gs.greedy_sweep_plain(_t(d), _t(c), _t(t), n_rows, k).numpy()
    assert np.array_equal(_emulate_sweep(d, c, t, n_rows, k), want)
    assert np.array_equal(_emulate_sweep(d, c, t, n_rows, k, tile=256,
                                         max_blocks=3, chunk=64), want)
    if case == "all_below":
        assert want.sum() > 0


def _pinned_norms(X, d):
    n = X[:, 0] * X[:, 0]
    for j in range(1, d):
        n = n + X[:, j] * X[:, j]
    return n


def _insert(bd, bi, sel, x, ci):
    """The kernels' insert, for the rows ``sel`` of (bd, bi): x goes in
    after every held entry with d2 <= x (all of lower index), the entries
    from there on move down one slot."""
    K = bd.shape[1]
    for s in range(K - 1, -1, -1):
        here = x < bd[sel, s]
        below = x < bd[sel, s - 1] if s > 0 else np.zeros_like(here)
        bd[sel, s] = np.where(here, np.where(below, bd[sel, s - 1], x),
                              bd[sel, s])
        bi[sel, s] = np.where(here, np.where(below, bi[sel, s - 1], ci),
                              bi[sel, s])


def _emulate_knn(Q, C, valid, k, r, n_ranges, span, threads=KNN_THREADS,
                 tile=KNN_TILE):
    """``knn_partial_kernel`` + ``knn_merge_kernel`` step by step, in f32,
    vectorized over the queries (each thread's R queries are independent):
    query q0 + r * threads + thread of each block; per control range,
    tiles of ``tile`` rows with the pinned norm (NaN for an invalid control
    or a row past the range) beside zero-padded columns (width d up to 8,
    else 64); per row the pinned d2 of every query, the strict test against
    the K-th (before the clamp, which the insert applies) and the insert;
    then the S partial top-k lists merged in range order with the same
    test, each list left at its first entry not below the K-th."""
    nq, d = Q.shape
    nc = C.shape[0]
    K = 1 if k <= 1 else 8 if k <= 8 else 16
    D = d if d <= 8 else 64
    big = np.float32(BIG)
    # the thread mapping: every query exactly once
    per = threads * r
    blocks = -(-nq // per)
    q_of = (np.arange(blocks)[:, None, None] * per
            + np.arange(r)[None, :, None] * threads
            + np.arange(threads)[None, None, :]).reshape(-1)
    q_of = q_of[q_of < nq]
    assert np.array_equal(np.sort(q_of), np.arange(nq))
    Qp = np.zeros((nq, D), np.float32)
    Qp[:, :d] = Q
    qn = _pinned_norms(Q, d)
    part_d = np.zeros((n_ranges, k, nq), np.float32)
    part_i = np.zeros((n_ranges, k, nq), np.int64)
    for g in range(n_ranges):
        bd = np.full((nq, K), big, np.float32)
        bi = np.full((nq, K), -1, np.int64)
        lo, hi = g * span, min((g + 1) * span, nc)
        for base in range(lo, hi, tile):
            rows = base + np.arange(tile)
            inside = rows < hi
            Cp = np.zeros((tile, D), np.float32)
            Cp[inside, :d] = C[rows[inside]]
            cn = np.full(tile, np.nan, np.float32)
            ok = inside.copy()
            ok[inside] = valid[rows[inside]]
            cn[ok] = _pinned_norms(Cp[ok], d)
            for rr in range(tile):
                dot = Qp[:, 0] * Cp[rr, 0]
                for j in range(1, D):
                    dot = dot + Qp[:, j] * Cp[rr, j]
                x = (qn + cn[rr]) - np.float32(2.0) * dot
                sel = np.flatnonzero(x < bd[:, K - 1])    # before the clamp
                if sel.size:
                    _insert(bd, bi, sel, np.maximum(x[sel], np.float32(0)),
                            np.full(sel.size, base + rr, np.int64))
        part_d[g], part_i[g] = bd[:, :k].T, bi[:, :k].T
    if n_ranges == 1:
        return part_d[0].T, part_i[0].T
    bd = np.full((nq, K), big, np.float32)
    bi = np.full((nq, K), -1, np.int64)
    for g in range(n_ranges):
        going = np.ones(nq, bool)
        for s in range(k):
            x = part_d[g, s]
            going &= x < bd[:, K - 1]
            sel = np.flatnonzero(going)
            if sel.size:
                _insert(bd, bi, sel, x[sel], part_i[g, s, sel])
    return bd[:, :k], bi[:, :k]


def _span(nc, n_ranges, tile):
    per = -(-nc // n_ranges)
    return max(tile, -(-per // tile) * tile)


KNN_CASES = {
    # name: (nq, nc, d, k, valid share, integer features, threads, tile,
    #        S asked for (None: the wrapper's plan on 132 SMs))
    "k1_ragged": (37, 300, 5, 1, 0.5, False, 4, 32, 3),
    "k8_ties": (50, 777, 5, 8, 0.6, True, 4, 128, 4),
    "k16_r2": (20, 513, 3, 16, 0.7, True, 8, 128, 2),
    "wide_padded": (9, 200, 9, 5, 0.5, False, 4, 64, 2),
    "all_invalid": (10, 300, 2, 3, 0.0, False, 4, 32, 3),
    "k_above_valid": (30, 300, 4, 16, 0.02, True, 4, 32, 2),
    "tie_at_boundary": (8, 300, 2, 8, 1.0, True, 4, 32, 3),
    "nan_features": (16, 200, 5, 8, 0.8, False, 4, 32, 2),
    "plan_split": (100, 4099, 5, 8, 0.9, False, KNN_THREADS, KNN_TILE, None),
    "plan_one_range": (300, 1000, 5, 1, 0.5, False, KNN_THREADS, KNN_TILE,
                       None),
}


@pytest.mark.parametrize("name", list(KNN_CASES))
def test_knn_topk_design_matches_plain(name):
    """The register-tiled, range-split k-NN of ``csrc/knn_topk.cu``,
    emulated step by step (R queries a thread, S control ranges, the
    merge), bit for bit against ``knn_topk_plain``: ties within and across
    a range boundary (the lower index first), all controls invalid, k above
    the valid count, NaN features, widths on the exact and the padded
    path, K = 1 / 8 / 16 (R = 4 / 4 / 2, 1 when wide), nq not a multiple
    of R x threads and nc not one of S or of the tile; then S = 1 on the
    same inputs, and the wrapper's own plan where it splits."""
    from repro_torch.kernels import knn_topk as tk
    nq, nc, d, k, share, integer, threads, tile, s = KNN_CASES[name]
    rng = np.random.default_rng(len(name) * 1000 + nq)
    if integer:
        Q = rng.integers(-2, 3, (nq, d)).astype(np.float32)
        C = rng.integers(-2, 3, (nc, d)).astype(np.float32)
    else:
        Q = rng.normal(0, 2, (nq, d)).astype(np.float32)
        C = rng.normal(0, 2, (nc, d)).astype(np.float32)
    v = rng.random(nc) < share
    if name == "tie_at_boundary":     # equal rows, valid from just before
        C[:] = C[0]                   # the first range's end
        v = np.arange(nc) >= _span(nc, s, tile) - 3
    if name == "nan_features":
        C[rng.random(nc) < 0.1, 1] = np.nan
        Q[::5, 0] = np.nan
    r = tk.queries_per_thread(k, d)
    if s is None:      # 132 SMs holding 4 blocks each
        r, qblocks, s, span = tk.plan(nq, nc, k, d, 132 * 4)
        assert qblocks == -(-nq // (threads * r))
        assert (s > 1) == (name == "plan_split")
    else:
        span = _span(nc, s, tile)
        assert -(-nc // span) == s
    pd, pi = tk.knn_topk_plain(_t(Q), _t(C), _t(v), k)
    want_d, want_i = _bits(pd.numpy()), pi.numpy()
    for n_ranges, sp in ((s, span), (1, max(tile, -(-nc // tile) * tile))):
        gd, gi = _emulate_knn(Q, C, v, k, r, n_ranges, sp, threads, tile)
        assert np.array_equal(_bits(gd), want_d), (name, n_ranges)
        assert np.array_equal(gi, want_i), (name, n_ranges)
    if name == "tie_at_boundary":
        assert np.array_equal(want_i[0], np.arange(8) + span - 3)


# ------------------------------------------------------ (c) entry points
def test_matching_entry_points_match_reference():
    """``knn_sorted_1d``, ``nnmwr`` (both engines), ``nnmwr_att`` and
    ``nnmnr`` against the reference: indices, ``ok`` and distances exact
    (integer features for the quadratic engine), the ATT within rtol
    1e-5."""
    from repro_torch.core import matching as tm
    rng = np.random.default_rng(5)
    n = 600
    x = rng.random(n).astype(np.float32)
    x[::7] = x[3]                               # exact ties in 1-D
    t = (rng.random(n) < 0.35).astype(np.int32)
    valid = rng.random(n) > 0.05
    cv = (t == 0) & valid
    y = (2.5 * t + 2.0 * x + rng.normal(0, 0.2, n)).astype(np.float32)
    for k, caliper in ((1, 0.01), (5, 0.1), (3, np.inf)):
        jd, ji = jm.knn_sorted_1d(jnp.asarray(x), jnp.asarray(x),
                                  jnp.asarray(cv), k, caliper)
        td, ti = tm.knn_sorted_1d(_t(x), _t(x), _t(cv), k, caliper)
        assert np.array_equal(_bits(td.numpy()), _bits(jd)), k
        assert np.array_equal(ti.numpy(), np.asarray(ji)), k
    U_int = rng.integers(-3, 4, (n, 3)).astype(np.float32)
    # the quadratic engine on integer-valued features, where every squared
    # distance is exact: XLA contracts |q|² + |c|² − 2q·c into an FMA for
    # d = 1, so real-valued inputs differ in the last bits of d2
    for U, engine, k, caliper in ((x[:, None], "auto", 1, 0.01),
                                  (U_int[:, :1], "quadratic", 2, 0.5),
                                  (U_int, "auto", 2, 2.0),
                                  (U_int, "quadratic", 1, np.inf)):
        jr = jm.nnmwr(jnp.asarray(U), jnp.asarray(t), jnp.asarray(valid),
                      k=k, caliper=caliper, engine=engine)
        tr = tm.nnmwr(_t(U), _t(t), _t(valid), k=k, caliper=caliper,
                      engine=engine)
        case = (U.shape[1], engine, k, caliper)
        assert np.array_equal(tr.ok.numpy(), np.asarray(jr.ok)), case
        assert np.array_equal(tr.treated_mask.numpy(),
                              np.asarray(jr.treated_mask)), case
        assert np.array_equal(tr.idx.numpy(), np.asarray(jr.idx)), case
        assert np.array_equal(_bits(tr.dist.numpy()), _bits(jr.dist)), case
        assert int(tr.n_matched_treated()) == int(jr.n_matched_treated())
        if caliper != np.inf:    # the reference's caliper >= 1.84e19 defect
            _close(tm.nnmwr_att(_t(y), tr),
                   jm.nnmwr_att(jnp.asarray(y), jr), msg=str(case))
    for U, engine, k in ((x[:, None], "auto", 1), (x[:, None], "auto", 5),
                         (U_int, "auto", 2), (U_int, "quadratic", 1)):
        jr = jm.nnmnr(jnp.asarray(U), jnp.asarray(t), jnp.asarray(valid),
                      k=k, caliper=0.5, engine=engine)
        tr = tm.nnmnr(_t(U), _t(t), _t(valid), k=k, caliper=0.5,
                      engine=engine)
        assert np.array_equal(tr.ok.numpy(), np.asarray(jr.ok)), (engine, k)
        ok = np.asarray(jr.ok)
        assert np.array_equal(tr.idx.numpy()[ok], np.asarray(jr.idx)[ok])
        used = tr.idx.numpy()[ok]
        assert len(used) == len(np.unique(used))


# -------------------------------------------------------- (d) distances
def test_distances_match_reference():
    from repro_torch.core import distance as td
    from repro_torch.data.columnar import Table
    rng = np.random.default_rng(7)
    n = 700
    A = rng.normal(0, 1, (n, 4))
    X = (A @ rng.normal(0, 1, (4, 4)) + [3, -1, 0, 10]).astype(np.float32)
    valid = rng.random(n) > 0.1
    _close(td.masked_covariance(_t(X), _t(valid)),
           jdist.masked_covariance(jnp.asarray(X), jnp.asarray(valid)),
           rtol=1e-4, atol=1e-4)
    _close(td.mahalanobis_transform(_t(X), _t(valid)),
           jdist.mahalanobis_transform(jnp.asarray(X), jnp.asarray(valid)),
           rtol=1e-4, atol=1e-4)
    cols = {f"x{j}": X[:, j] for j in range(4)}
    cols["i"] = np.arange(n, dtype=np.int32)
    names = ["x2", "i", "x0"]
    _close(td.features(Table.from_numpy(cols, device="cpu"), names),
           jdist.features(JTable.from_numpy(cols), names), rtol=0, atol=0)
    _close(td.pairwise_sqdist(_t(X[:50]), _t(X[50:130])),
           jdist.pairwise_sqdist(jnp.asarray(X[:50]), jnp.asarray(X[50:130])),
           rtol=1e-4, atol=1e-2)
    ps = rng.random(n).astype(np.float32)
    _close(td.ps_distance_features(_t(ps)),
           jdist.ps_distance_features(jnp.asarray(ps)), rtol=0, atol=0)


# ------------------------------------------------------ (e) offline CEM
def _cem_data(n=3000, seed=3):
    rng = np.random.default_rng(seed)
    cols = dict(
        a=rng.integers(0, 5, n).astype(np.int32),
        b=rng.integers(0, 3, n).astype(np.int32),
        u=rng.normal(0, 1, n).astype(np.float32),
        w=rng.uniform(-1, 11, n).astype(np.float32),
        t=(rng.random(n) < 0.3).astype(np.int32),
        y=rng.normal(5, 2, n).astype(np.float32))
    return cols, rng.random(n) > 0.08


def _assert_estimate(te, je):
    for f in ("n_matched_treated", "n_matched_control", "n_groups"):
        assert float(getattr(te, f)) == float(getattr(je, f)), f
    _close(te.ate, je.ate, msg="ate")
    _close(te.att, je.att, msg="att")
    _close(te.variance, je.variance, rtol=1e-4, msg="variance")


def _assert_groups(tg, jg):
    assert np.array_equal(tg.keep.numpy(), np.asarray(jg.keep))
    for f in ("n_treated", "n_control"):
        assert np.array_equal(getattr(tg, f).numpy(),
                              np.asarray(getattr(jg, f))), f
    for f in ("sum_y_t", "sum_y_c"):
        _close(getattr(tg, f), getattr(jg, f), msg=f)


def test_offline_cem_matches_reference():
    """``pack_keys``, ``cem``, ``exact_matching``, ``estimate_ate`` with
    and without variance, ``cem_weights``, ``difference_in_means``, the
    grouping helpers and ``Table.count`` / ``select``."""
    from repro_torch.core import CoarsenSpec
    from repro_torch.core import ate as tate
    from repro_torch.core import coarsen_columns as tcoarsen_columns
    tcem = importlib.import_module("repro_torch.core.cem")
    from repro_torch.core import groupby as tgb
    from repro.core import groupby as jgb
    cols, valid = _cem_data()
    jt, tt = _tables(cols, valid)
    assert int(tt.count()) == int(jt.count())
    assert list(tt.select(["y", "a"]).columns) == list(
        jt.select(["y", "a"]).columns)
    mk = lambda S: {"a": S.categorical(5), "u": S.equal_width(-2, 2, 4),
                    "w": S.from_cutpoints([0.0, 2.5, 5.0, 7.5, 10.0])}
    jspecs, tspecs = mk(JSpec), mk(CoarsenSpec)
    jcodec, jhi, jlo = jcem.pack_keys(jt, jspecs)
    tcodec, thi, tlo = tcem.pack_keys(tt, tspecs)
    assert tcodec.fields == jcodec.fields
    assert np.array_equal(thi.numpy(), np.asarray(jhi, np.int64))
    assert np.array_equal(tlo.numpy(), np.asarray(jlo, np.int64))
    jres = jcem.cem(jt, "t", "y", jspecs)
    tres = tcem.cem(tt, "t", "y", tspecs)
    buckets = {k: np.asarray(jcoarsen(jt[k], s)) for k, s in jspecs.items()}
    tcols = tcoarsen_columns({k: tt[k] for k in tspecs}, tspecs)
    jcols = jcoarsen_columns({k: jt[k] for k in jspecs}, jspecs)
    assert list(tcols) == list(jcols)
    for k, b in jcols.items():
        assert np.array_equal(tcols[k].numpy(), np.asarray(b, np.int64))
        assert np.array_equal(tcols[k].numpy(), buckets[k])
    omask, _ = oracle.cem_oracle(buckets, cols["t"], valid)
    for jr, tr, mask in ((jres, tres, omask),
                         (jcem.exact_matching(jt, "t", "y", {"a": 5, "b": 3}),
                          tcem.exact_matching(tt, "t", "y", {"a": 5, "b": 3}),
                          None)):
        tv = tr.table.valid.numpy()
        assert np.array_equal(tv, np.asarray(jr.table.valid))
        if mask is not None:
            assert np.array_equal(tv, mask)
        assert np.array_equal(tr.table["subclass"].numpy()[tv],
                              np.asarray(jr.table["subclass"])[tv])
        _assert_groups(tr.groups, jr.groups)
        g = tr.groups.grouping
        assert np.array_equal(g.row_group().numpy(),
                              np.asarray(jr.groups.grouping.row_group()))
        for jn, tn in zip(jr.groups.matched_counts(),
                          tr.groups.matched_counts()):
            assert float(tn) == float(jn)
        _assert_estimate(tate.estimate_ate(tr.groups),
                         jate.estimate_ate(jr.groups))
        _assert_estimate(
            tate.estimate_ate(tr.groups, tt["y"], tt["t"], tr.table.valid),
            jate.estimate_ate(jr.groups, jt["y"], jt["t"], jr.table.valid))
        _close(tate.cem_weights(tr.groups, tt["t"], tr.table.valid),
               jate.cem_weights(jr.groups, jt["t"], jr.table.valid))
        mn, mx = tgb.group_minmax(g, tt["t"])
        jmn, jmx = jgb.group_minmax(jr.groups.grouping, jt["t"])
        real = np.asarray(jr.groups.grouping.group_valid)
        assert np.array_equal(mn.numpy()[real], np.asarray(jmn)[real])
        assert np.array_equal(mx.numpy()[real], np.asarray(jmx)[real])
    _close(tate.difference_in_means(tt["y"], tt["t"], tt.valid),
           jate.difference_in_means(jt["y"], jt["t"], jt.valid))


# ------------------------------------------- (f) subclassification, AWMD
def test_subclassification_and_balance_match_reference():
    """``ntile``, ``subclassify`` (trimmed and not), ``awmd`` and
    ``raw_imbalance``, both packages given the same propensity scores."""
    from repro_torch.core import balance as tbal
    tcem = importlib.import_module("repro_torch.core.cem")
    from repro_torch.core import CoarsenSpec
    from repro_torch.core import subclassification as tsub
    cols, valid = _cem_data(n=2500, seed=9)
    rng = np.random.default_rng(9)
    ps = rng.random(2500).astype(np.float32)
    ps[::11] = ps[4]                            # ties in the ordering
    ps[5], ps[6] = np.float32(0.1), np.float32(0.9)   # on the trim bounds
    jt, tt = _tables(cols, valid)
    for n in (1, 5, 7):
        got = tsub.ntile(_t(ps), _t(valid), n).numpy()
        assert np.array_equal(got, np.asarray(jsub.ntile(
            jnp.asarray(ps), jnp.asarray(valid), n))), n
        assert np.array_equal(got, oracle.ntile_oracle(ps, valid, n)), n
    covs = ("u", "w", "a")
    for trim, n in (((0.1, 0.9), 5), (None, 4)):
        jr = jsub.subclassify(jt, "t", "y", jnp.asarray(ps), n_subclasses=n,
                              trim=trim)
        tr = tsub.subclassify(tt, "t", "y", _t(ps), n_subclasses=n,
                              trim=trim)
        tv = tr.table.valid.numpy()
        assert np.array_equal(tv, np.asarray(jr.table.valid)), trim
        assert np.array_equal(tr.table["subclass"].numpy()[tv],
                              np.asarray(jr.table["subclass"])[tv])
        _assert_groups(tr.groups, jr.groups)
        tb = tbal.awmd(tr.groups, {c: tt[c] for c in covs}, tt["t"],
                       tr.table.valid)
        jb = jbal.awmd(jr.groups, {c: jt[c] for c in covs}, jt["t"],
                       jr.table.valid)
        for c in covs:
            _close(tb[c], jb[c], msg=c)
    tres = tcem.cem(tt, "t", "y", {"a": CoarsenSpec.categorical(5)})
    jres = jcem.cem(jt, "t", "y", {"a": JSpec.categorical(5)})
    tb = tbal.awmd(tres.groups, {c: tt[c] for c in covs}, tt["t"],
                   tres.table.valid)
    jb = jbal.awmd(jres.groups, {c: jt[c] for c in covs}, jt["t"],
                   jres.table.valid)
    tr_ = tbal.raw_imbalance({c: tt[c] for c in covs}, tt["t"], tt.valid)
    jr_ = jbal.raw_imbalance({c: jt[c] for c in covs}, jt["t"], jt.valid)
    for c in covs:
        _close(tb[c], jb[c], msg=c)
        _close(tr_[c], jr_[c], msg=c)


# ----------------------------------------------- (g) the slice as a whole
def _awmd_match(cols, ok, idx, tmask, covs):
    """``benchmarks/bench_quality.py``'s AWMD over a k-NN matched sample."""
    tm_ = tmask & ok.any(1)
    used = idx[ok]
    return (int(tm_.sum()), len(np.unique(used)),
            [abs(cols[c][tm_].mean() - cols[c][used].mean()) for c in covs])


def test_table3_pipeline_matches_reference():
    """``bench_quality.main``'s pipeline (paper Table 3, treatment snow) at
    8,192 flights through both packages: the generated relation equal; the
    propensity model within rel 1e-4; given the reference's scores, every
    reported count exact and every AWMD within rtol 1e-5."""
    import torch
    from repro_torch.core import (CoarsenSpec, awmd, cem, estimate_ate,
                                  exact_matching, fit_logistic, nnmnr, nnmwr,
                                  predict_ps, subclassify)
    from repro_torch.data import flightgen
    n = 8192
    jdata = jflightgen.generate(n_flights=n, n_airports=6, seed=1)
    tdata = flightgen.generate(n_flights=n, n_airports=6, seed=1,
                               device="cpu")
    jt, tt = jdata.integrated, tdata.integrated
    names = sorted(jt.columns)
    assert sorted(tt.columns) == names
    for c in names:
        assert np.array_equal(tt[c].numpy(), np.asarray(jt[c])), c
    cols = {c: tt[c].numpy() for c in names}
    covs = ("w_visim", "w_wspdm", "traffic", "carrier_traffic")
    ps_features = ["traffic", "w_season", "w_tempm", "w_wspdm", "w_precipm"]

    jX = jnp.stack([jt[f].astype(jnp.float32) for f in ps_features], -1)
    jmodel = jprop.fit_logistic(jX, jt["snow"], jt.valid)
    jps = jprop.predict_ps(jmodel, jX)
    tX = torch.stack([tt[f].to(torch.float32) for f in ps_features], -1)
    tmodel = fit_logistic(tX, tt["snow"], tt.valid)
    for f in ("w", "mean", "std"):
        _close(getattr(tmodel, f), getattr(jmodel, f), rtol=1e-4, msg=f)
    _close(predict_ps(tmodel, tX), jps, rtol=1e-4)
    ps = np.asarray(jps)                   # downstream: the same scores
    tps = _t(ps)

    for jfn, tfn in ((jm.nnmwr, nnmwr), (jm.nnmnr, nnmnr)):
        jr = jfn(jnp.asarray(ps[:, None]), jt["snow"], jt.valid, k=1,
                 caliper=0.001)
        tr = tfn(tps[:, None], tt["snow"], tt.valid, k=1, caliper=0.001)
        jn = _awmd_match(cols, np.asarray(jr.ok), np.asarray(jr.idx),
                         np.asarray(jr.treated_mask), covs)
        tn = _awmd_match(cols, tr.ok.numpy(), tr.idx.numpy(),
                         tr.treated_mask.numpy(), covs)
        assert tn[:2] == jn[:2], jfn.__name__
        np.testing.assert_allclose(tn[2], jn[2], rtol=1e-5, atol=1e-5)

    jsres = jsub.subclassify(jt, "snow", "dep_delay", jnp.asarray(ps),
                             n_subclasses=5)
    tsres = subclassify(tt, "snow", "dep_delay", tps, n_subclasses=5)
    em = {"airport": 16, "carrier": 16}
    mk = lambda S: {"airport": S.categorical(16),
                    "traffic": S.equal_width(0, 40, 8),
                    "w_tempm": S.equal_width(-20, 40, 5),
                    "w_wspdm": S.equal_width(0, 80, 5)}
    pairs = [(jsres, tsres, True),
             (jcem.exact_matching(jt, "snow", "dep_delay", em),
              exact_matching(tt, "snow", "dep_delay", em), False),
             (jcem.cem(jt, "snow", "dep_delay", mk(JSpec)),
              cem(tt, "snow", "dep_delay", mk(CoarsenSpec)), True)]
    for jr, tr, balance in pairs:
        je, te = jate.estimate_ate(jr.groups), estimate_ate(tr.groups)
        assert int(te.n_matched_control) == int(je.n_matched_control)
        assert int(te.n_matched_treated) == int(je.n_matched_treated)
        assert np.array_equal(tr.table.valid.numpy(),
                              np.asarray(jr.table.valid))
        if balance:
            tb = awmd(tr.groups, {c: tt[c] for c in covs}, tt["snow"],
                      tr.table.valid)
            jb = jbal.awmd(jr.groups, {c: jt[c] for c in covs}, jt["snow"],
                           jr.table.valid)
            for c in covs:
                _close(tb[c], jb[c], msg=c)
    buckets = {k: np.asarray(jcoarsen(jt[k], s))
               for k, s in mk(JSpec).items()}
    omask, _ = oracle.cem_oracle(buckets, cols["snow"], tt.valid.numpy())
    assert np.array_equal(pairs[2][1].table.valid.numpy(), omask)
