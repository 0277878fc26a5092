"""The port's four kernels (repro_torch.kernels) on the CPU: their plain
PyTorch versions against the reference's oracles (repro.kernels.ref), its
Pallas kernels in interpret mode (repro.kernels.ops, as
tests/test_kernels.py runs them) and its jnp paths, plus a step-by-step
emulation of each CUDA kernel's loop that must agree with the plain
version BIT FOR BIT (the kernels cannot run here; this pins their
summation order to the plain version's). The ``_port_*`` functions hold
the port's side; they import torch when they run, never at collection.

Few test items on purpose, here and in the other ``test_torch_*``
modules: each groups its cases into one or two tests. The tier-1 command
hands tests to six xdist workers in chunks that grow with the number of
tests still pending, and tests collected after
``test_property_online.py``, as these are, enlarge the run of
consecutive property tests one worker receives. A worker that compiles
too many of them runs out of memory maps (``vm.max_map_count``) inside
XLA:CPU compilation and crashes; the suite does so now and then without
these modules too, and they should not make it likelier. For the same
reason every test here that compiles reference programs drops the
worker's compiled programs (``jax.clear_caches()``) before and after it
runs: that frees the maps the worker's earlier tests left and those it
made itself.

The kernel-against-plain tests on the card are in
``tests/test_torch_cuda.py`` (marked ``cuda``; they import no JAX, so
they run on a machine with the card).

Tolerances: integer-valued inputs (keys, counts) must match exactly.
Float sums are compared with rtol 1e-5: the reference reduces in XLA's
order (sequential scatter-add or a one-hot matmul), the port in its
pinned pairwise order, and f32 sums of at most a few thousand
unit-scale terms in two different orders differ by a few ulps of the
largest partial sum.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from repro.core.coarsen import CoarsenSpec as JSpec
from repro.core.coarsen import coarsen as jcoarsen
from repro.core.keys import KeyCodec as JCodec
from repro.kernels import cem_keys_op as j_cem_keys_op
from repro.kernels import ref as jref
from repro.kernels import scatter_merge_op as j_scatter_merge_op
from repro.kernels import segment_sums_op as j_segment_sums_op
from repro.kernels.segment_stats import chunked_sum as j_chunked_sum

RTOL = 1e-5


def _t(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


def _sorted_segments(rng, n, n_groups, invalid_frac):
    """Sorted segment ids with a long trailing pseudo-group (the invalid
    rows) and a random permutation, like a group-by's output."""
    n_inv = int(n * invalid_frac)
    seg = np.sort(rng.integers(0, n_groups, n - n_inv))
    _, seg = np.unique(seg, return_inverse=True)
    seg = np.concatenate([seg, np.full(n_inv, seg.max() + 1 if n > n_inv
                                       else 0)]).astype(np.int64)
    return seg, rng.permutation(n).astype(np.int64)


# ------------------------------------------------------------------ cem_keys
def _random_specs(rng, d):
    specs = {}
    for j in range(d):
        if j % 3 == 2:
            card = int(rng.integers(2, 20))
            specs[f"c{j}"] = (card, None)
        else:
            k = int(rng.integers(1, 7))
            specs[f"c{j}"] = (None, sorted(rng.normal(0, 2, k).tolist()))
    return specs


def _port_cem_keys(X, valid, raw):
    """The port's kernel route (categoricals as cutpoints 1..card-1) and
    its own coarsen + pack, on the same inputs."""
    import torch
    from repro_torch.core.coarsen import CoarsenSpec, coarsen
    from repro_torch.core.keys import KeyCodec
    from repro_torch.kernels import cem_keys as ck
    from repro_torch.kernels.ops import CutpointTable
    specs = {k: (CoarsenSpec.categorical(c) if c else
                 CoarsenSpec.from_cutpoints(cu)) for k, (c, cu) in raw.items()}
    codec = KeyCodec.from_cardinalities(
        {k: s.n_buckets for k, s in specs.items()})
    tab = CutpointTable.for_codec(codec, specs, "cpu")
    hi, lo = ck.cem_keys(_t(X), tab.cutpoints, tab.n_cuts, tab.widths,
                         _t(valid))
    tb = {k: coarsen(_t(X[:, j]), specs[k])
          for j, k in enumerate(codec.names)}
    th, tl = codec.pack(tb, _t(valid))
    return dict(hi=hi.numpy(), lo=lo.numpy(), names=codec.names,
                cutpoints=tab.cutpoints.numpy(), n_cuts=list(tab.n_cuts),
                widths=list(tab.widths),
                kernel_cutpoints=[specs[k].kernel_cutpoints()
                                  for k in codec.names],
                own_pack_equal=bool(torch.equal(hi, th)
                                    and torch.equal(lo, tl)))


def _check_cem_keys_plain_matches_reference(n, d):
    rng = np.random.default_rng(n + d)
    raw = _random_specs(rng, d)
    X = np.empty((n, d), np.float32)
    for j, (_, (card, _)) in enumerate(sorted(raw.items())):
        X[:, j] = (rng.integers(0, card, n) if card else
                   rng.normal(0, 3, n))
    valid = rng.random(n) > 0.2
    got = _port_cem_keys(X, valid, raw)
    jspecs = {k: (JSpec.categorical(c) if c else JSpec.from_cutpoints(cu))
              for k, (c, cu) in raw.items()}
    jcodec = JCodec.from_cardinalities(
        {k: s.n_buckets for k, s in jspecs.items()})
    names = got["names"]
    assert names == jcodec.names
    # reference 1: coarsen + KeyCodec.pack (jnp)
    jb = {k: jcoarsen(jnp.asarray(X[:, j]), jspecs[k])
          for j, k in enumerate(names)}
    want_hi, want_lo = jcodec.pack(jb, jnp.asarray(valid))
    np.testing.assert_array_equal(got["hi"], np.asarray(want_hi))
    np.testing.assert_array_equal(got["lo"], np.asarray(want_lo))
    # reference 2: the oracle cem_keys_ref on the same cutpoint table
    rh, rl = jref.cem_keys_ref(jnp.asarray(X), jnp.asarray(got["cutpoints"]),
                               got["n_cuts"], got["widths"],
                               jnp.asarray(valid))
    np.testing.assert_array_equal(got["hi"], np.asarray(rh))
    np.testing.assert_array_equal(got["lo"], np.asarray(rl))
    # reference 3: the Pallas kernel (interpret mode)
    ph, pl = j_cem_keys_op(jnp.asarray(X), got["kernel_cutpoints"],
                           got["widths"], jnp.asarray(valid))
    np.testing.assert_array_equal(got["hi"], np.asarray(ph))
    np.testing.assert_array_equal(got["lo"], np.asarray(pl))
    # and the port's own coarsen + pack
    assert got["own_pack_equal"]


def _port_cem_keys_table(X, valid, cuts, widths):
    from repro_torch.kernels import cem_keys as ck
    from repro_torch.kernels.ops import CutpointTable
    tab = CutpointTable.build(cuts, widths, "abcd", "cpu")
    hi, lo = ck.cem_keys(_t(X), tab.cutpoints, tab.n_cuts, tab.widths,
                         _t(valid))
    return hi.numpy(), lo.numpy()


def _check_cem_keys_matches_reference_op():
    rng = np.random.default_rng(5)
    X = rng.normal(0, 3, (300, 4)).astype(np.float32)
    valid = rng.random(300) > 0.3
    cuts = [sorted(rng.normal(0, 2, k).tolist()) for k in (1, 3, 5, 2)]
    widths = [2, 2, 3, 2]
    hi, lo = _port_cem_keys_table(X, valid, cuts, widths)
    jh, jl = j_cem_keys_op(jnp.asarray(X), cuts, widths, jnp.asarray(valid),
                           block=64)
    np.testing.assert_array_equal(hi, np.asarray(jh))
    np.testing.assert_array_equal(lo, np.asarray(jl))
    assert (hi[~valid] == 0xFFFFFFFF).all()


# -------------------------------------------------------------- segment sums
# The tree kernels' constants (csrc/segment_tree.cuh): rows a warp loads
# before its window, columns per block of the tile kernel, and the fold's
# warps, buffer per warp and columns per pass.
TREE_BACK, TREE_CW = 32, 4
FOLD_WARPS, FOLD_BUF, FOLD_CG = 8, 1024, 16


def _push(stack, r, carry):
    """tree_push: item r onto the binary-counter stack (arrays of columns;
    level k joins ``stack[k] + carry``)."""
    k = 0
    while (r >> k) & 1:
        carry = (stack[k] + carry).astype(np.float32)
        k += 1
    stack[k] = carry


def _fold(stack, r):
    """tree_fold: the stack of r items, joined from the lowest level up; a
    level with no right operand passes through."""
    acc = None
    for k in range(64):
        if (r >> k) & 1:
            acc = stack[k] if acc is None else (stack[k] + acc).astype(
                np.float32)
    return acc


def _pairwise(items):
    """The pinned tree over the rows of ``items`` (a chunk's levels in
    shared memory): level k adds row a + 2^k onto row a, a a multiple of
    2^(k+1), where it exists."""
    buf = items.copy()
    h = 1
    while h < buf.shape[0]:
        for a in range(0, buf.shape[0] - h, 2 * h):
            buf[a] = buf[a] + buf[a + h]
        h *= 2
    return buf[0]


def _run_start_search(keys, hi, key):
    """tree_run_start: 32 probes a step, galloping back by powers of 32
    from stride 32 (the 32 rows before the window are in the run), then
    narrowing; keys[hi] == key."""
    lanes = np.arange(32, dtype=np.int64)
    n = keys.shape[0]
    step = 32
    while True:
        j = hi - step * (lanes + 1)
        differs = (j < 0) | (keys[np.clip(j, 0, n - 1)] != key)
        if differs.any():
            f = int(np.argmax(differs))
            lo, hi = hi - step * (f + 1), hi - step * f
            break
        hi, step = hi - step * 32, step * 32
    while hi - lo > 1:
        step = (hi - lo + 31) // 32
        j = lo + step * (lanes + 1)
        equal = (j >= hi) | ((j >= 0) & (keys[np.clip(j, 0, n - 1)] == key))
        f = int(np.argmax(equal))
        hi, lo = min(hi, lo + step * (f + 1)), lo + step * f
    return hi


def _emulate_tree(vals, perm, keys, g, dst, merge, tile):
    """The tree kernels (csrc/segment_tree.cuh), step by step, in f32, on
    the host: ``run_tiles_kernel`` — per window of ``tile`` rows, its
    warp's region of rows [w0 - 32, w0 + 2 * tile) (index 32t + lane is
    lane ``lane``'s row of ballot word t), the head and kept bits, the
    start of the run crossing into the window (from the heads, or the
    warp's search), each row's tile and the levels at which it is a left
    node, the window's fold record, then per block of four columns the
    gather and the in-tile levels (a row's right operand at level k is
    row + 2^k: a shuffle below 32, a register 2^k / 32 words on above; a
    vectorized add over the rows here) and the tile heads' writes (a
    one-tile run to ``dst``, else a slot); then ``run_fold_kernel`` — each
    recorded run's tile sums folded per super-chunk: eight chunks of a
    power of two tiles, each folded by the tree, the eight sums joined by
    the tree, the super-chunks by the binary counter. ``dst`` is updated
    in place (``merge``: added onto)."""
    n, s = vals.shape
    log = tile.bit_length() - 1
    region = TREE_BACK + 2 * tile
    nw = -(-n // tile)
    rec = np.zeros((nw, 2), np.int64)
    slots = np.zeros((nw, 2, s), np.float32)      # slot A, slot B
    idx = np.arange(region)
    q = np.arange(2 * tile)
    for m in range(nw):
        w0, w1, r0 = m * tile, min(m * tile + tile, n), m * tile - TREE_BACK
        r = r0 + idx
        inside = (r >= 0) & (r < n)
        k = np.where(inside, keys[np.clip(r, 0, n - 1)], 0)
        before = np.concatenate([[0], k[:-1]])
        head = (r >= n) | (r == 0) | ((r > 0) & (idx > 0) & (before != k))
        kept = inside & (k >= 0) & (k < g)
        prev = np.maximum.accumulate(np.where(head, idx, -1))
        nxt = np.minimum.accumulate(np.where(head, idx, region)[::-1])[::-1]
        nxt = np.concatenate([nxt[1:], [region]])     # first head > ri
        s_cross = -1
        if not head[TREE_BACK] and kept[TREE_BACK]:
            ph = prev[TREE_BACK]
            s_cross = (r0 + ph if ph >= 0 else
                       _run_start_search(keys, r0, keys[w0]))
        ri = q + TREE_BACK
        row = w0 + q
        ok = (row < n) & kept[ri]
        rs = np.where(prev[ri] >= 0, r0 + prev[ri], s_cross)
        t0 = rs + ((row - rs) & ~(tile - 1))
        own = ok & (t0 >= w0) & (t0 < w1)
        re = r0 + nxt[ri]
        te = np.minimum(t0 + tile, re)
        first, last = t0 == rs, te == re
        t0r, ter = t0 - w0, te - w0
        reg = own & (row == t0) & ~first & last
        rec[m] = (rs[reg][0], re[reg][0]) if reg.any() else (-1, 0)
        heads = np.flatnonzero(own & (q == t0r))
        # levels at which a row is a left node: its offset in the tile a
        # multiple of 2^(k+1), row + 2^k inside the tile
        rel, rem = np.maximum(q - t0r, 0), np.maximum(ter - q, 1)
        ctz = np.where(rel > 0, np.log2(np.maximum(rel & -rel, 1)), log)
        nlev = np.minimum(ctz, np.ceil(np.log2(rem))).astype(np.int64)
        for c0 in range(0, s, TREE_CW):
            cw = min(TREE_CW, s - c0)
            v = np.zeros((cw, 2 * tile), np.float32)
            src = row[own] if perm is None else perm[row[own]]
            v[:, own] = vals[src, c0:c0 + cw].T
            for lv in range(log):
                h = 1 << lv
                sel = q[own & (nlev > lv)]
                v[:, sel] = v[:, sel] + v[:, sel + h]
            for hq in heads:
                if first[hq] and last[hq]:
                    cell = keys[w0 + hq]
                    dst[cell, c0:c0 + cw] = (dst[cell, c0:c0 + cw] + v[:, hq]
                                             if merge else v[:, hq])
                else:
                    slots[m, int(first[hq]), c0:c0 + cw] = v[:, hq]
    for m in range(nw):
        if rec[m, 0] < 0:
            continue
        lo, hi = rec[m]
        tiles = -(-(hi - lo) // tile)
        m0 = lo // tile
        sums = np.stack([slots[m0 + j, int(j == 0)] for j in range(tiles)])
        cell = keys[lo]
        for c0 in range(0, s, FOLD_CG):
            cg = min(FOLD_CG, s - c0)
            ch = 1 << ((FOLD_BUF // cg).bit_length() - 1)
            sup = ch * FOLD_WARPS
            supers = -(-tiles // sup)
            stack = {}
            for sc in range(supers):
                part = [_pairwise(sums[c * ch:(c + 1) * ch, c0:c0 + cg])
                        for c in range(sc * FOLD_WARPS, (sc + 1) * FOLD_WARPS)
                        if c * ch < tiles]
                _push(stack, sc, _pairwise(np.stack(part)))
            v = _fold(stack, supers)
            dst[cell, c0:c0 + cg] = (dst[cell, c0:c0 + cg] + v if merge
                                     else v)
    return dst


def _emulate_segment_sums(vals, perm, seg, g, tile):
    """``segment_sums_launch``: out zero-filled, then the tree kernels."""
    out = np.zeros((g, vals.shape[1]), np.float32)
    return _emulate_tree(vals, perm, seg, g, out, False, tile)


def _port_segment_sums_plain(vals, perm, seg, g):
    """The plain version, whether the CPU wrapper is it, and the kernels'
    tile."""
    import torch
    from repro_torch.kernels import segment_stats as ss
    got = ss.segment_sums_plain(_t(vals), _t(perm), _t(seg), g)
    wrapper = ss.segment_sums(_t(vals), _t(perm), _t(seg), g)
    return got.numpy(), bool(torch.equal(wrapper, got)), ss.SEGMENT_TILE


def _check_segment_sums_emulation(vals, perm, seg, g):
    got, wrapper_is_plain, kernel_tile = _port_segment_sums_plain(
        vals, perm, seg, g)
    # the kernel's tile, and a small one: the tree does not depend on it
    for tile in (kernel_tile, 16):
        want = _emulate_segment_sums(vals, perm, seg, g, tile)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    # the CPU wrapper is the plain version
    assert wrapper_is_plain


def _check_segment_sums_plain_matches_kernel_loop(n, s, groups, inv):
    rng = np.random.default_rng(n * s)
    vals = rng.normal(0, 1, (n, s)).astype(np.float32)
    seg, perm = _sorted_segments(rng, n, groups, inv)
    _check_segment_sums_emulation(vals, perm, seg, int(seg.max()) + 1)


# run lengths around the tile and window edges (each run after the first
# starts mid-window), and one of 65,537 rows: one more than 256 tiles
RUN_LENGTHS = (1, 2, 255, 256, 257, 511, 512, 513, 3, 65537, 1, 300)


def _runs_with_signed_zeros(rng, s):
    """Segment ids of RUN_LENGTHS (in a shuffled order after a 37-row run,
    so later runs start mid-window), -1 rows between two of them (dropped
    ids between kept ones, as the batched re-sort merge passes them) and
    a dropped tail; values with -0.0 runs: a one-row run and a 257-row run
    of -0.0 (a sum that must stay -0.0), and -0.0 scattered elsewhere."""
    lengths = [37] + list(rng.permutation(RUN_LENGTHS))
    seg, sid = [], 0
    for i, length in enumerate(lengths):
        seg += [sid] * int(length)
        sid += 1
        if i == 3:
            seg += [-1] * 5
    g = sid
    seg += [g] * 40                                  # dropped tail
    seg = np.asarray(seg, np.int64)
    n = seg.shape[0]
    vals = rng.normal(0, 1, (n, s)).astype(np.float32)
    vals[rng.random((n, s)) < 0.05] = np.float32(-0.0)
    starts = np.flatnonzero(np.r_[True, seg[1:] != seg[:-1]])
    lens = np.diff(np.r_[starts, n])
    one = starts[lens == 1][0]
    vals[one] = np.float32(-0.0)
    z = starts[lens == 257][0]
    vals[z:z + 257] = np.float32(-0.0)
    return seg, vals, g


def _check_segment_sums_run_lengths(s):
    rng = np.random.default_rng(100 + s)
    seg, vals, g = _runs_with_signed_zeros(rng, s)
    perm = np.arange(seg.shape[0], dtype=np.int64)
    _check_segment_sums_emulation(vals, perm, seg, g)
    # the same rows gathered through a random permutation
    perm = rng.permutation(seg.shape[0]).astype(np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    _check_segment_sums_emulation(vals[inv], perm, seg, g)


def _port_segment_sums(vals, seg, g):
    import torch
    from repro_torch.kernels import segment_stats as ss
    return ss.segment_sums(_t(vals), torch.arange(vals.shape[0]), _t(seg),
                           g).numpy()


def _check_segment_sums_matches_reference(n, s, block):
    rng = np.random.default_rng(n + s)
    seg, _ = _sorted_segments(rng, n, n // 8, 0.25)
    g = int(seg.max()) + 1
    counts = rng.integers(0, 2, (n, s)).astype(np.float32)
    floats = rng.normal(0, 10, (n, s)).astype(np.float32)
    for vals, exact in ((counts, True), (floats, False)):
        got = _port_segment_sums(vals, seg, g)
        want_xla = np.asarray(jax.ops.segment_sum(
            jnp.asarray(vals), jnp.asarray(seg.astype(np.int32)),
            num_segments=g))
        want_pallas = np.asarray(j_segment_sums_op(
            jnp.asarray(vals), jnp.asarray(seg.astype(np.int32)), g,
            block=block))
        for want in (want_xla, want_pallas):
            if exact:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


# ------------------------------------------------------------- scatter merge
def _emulate_scatter_merge(table, pos, vals, tile):
    """``scatter_merge_launch``: the tree kernels on the delta rows (no
    perm), each run's sum added onto its cell."""
    return _emulate_tree(vals, None, pos, table.shape[0], table.copy(), True,
                         tile)


def _port_scatter_merge_plain(table, pos, vals):
    from repro_torch.kernels import segment_stats as ss
    out = ss.scatter_merge_plain(_t(table.copy()), _t(pos), _t(vals))
    return out.numpy(), ss.SEGMENT_TILE


def _port_scatter_merge(table, pos, vals):
    from repro_torch.kernels import segment_stats as ss
    return ss.scatter_merge(_t(table.copy()), _t(pos), _t(vals)).numpy()


def _check_scatter_merge_emulation(table, pos, vals):
    got, kernel_tile = _port_scatter_merge_plain(table, pos, vals)
    for tile in (kernel_tile, 16):
        want = _emulate_scatter_merge(table, pos, vals, tile)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def _check_scatter_merge_plain_matches_kernel_loop(c, b, s):
    rng = np.random.default_rng(c + b)
    table = rng.normal(0, 5, (c, s)).astype(np.float32)
    vals = rng.normal(0, 1, (b, s)).astype(np.float32)
    # non-decreasing positions with runs of duplicates, like the fast path
    pos = np.sort(rng.integers(0, c, b)).astype(np.int64)
    pos[-max(1, b // 5):] = c - 1            # the invalid-row tail
    _check_scatter_merge_emulation(table, pos, vals)


def _check_scatter_merge_run_lengths(s):
    """Runs of duplicate positions of RUN_LENGTHS, positions below 0 and
    past the table (dropped), and -0.0 in the delta and the table."""
    rng = np.random.default_rng(200 + s)
    seg, vals, g = _runs_with_signed_zeros(rng, s)
    # non-decreasing: the -1 rows join the run before them
    pos = np.maximum.accumulate(seg)
    c = g + 3
    pos = np.where(pos >= g, c + 2, pos + 2)         # a dropped tail
    pos[:3] = -1
    table = rng.normal(0, 5, (c, s)).astype(np.float32)
    table[rng.random((c, s)) < 0.2] = np.float32(-0.0)
    _check_scatter_merge_emulation(table, pos.astype(np.int64), vals)


def _check_scatter_merge_matches_reference(c, b, s):
    rng = np.random.default_rng(c * 7 + b)
    table = rng.integers(0, 5, (c, s)).astype(np.float32)
    vals = rng.integers(-2, 3, (b, s)).astype(np.float32)
    pos = rng.integers(0, c, b).astype(np.int64)   # duplicates, unsorted
    got = _port_scatter_merge(table, pos, vals)
    want_ref = np.asarray(jref.scatter_merge_ref(
        jnp.asarray(table), jnp.asarray(pos.astype(np.int32)),
        jnp.asarray(vals)))
    want_pallas = np.asarray(j_scatter_merge_op(
        jnp.asarray(table), jnp.asarray(pos.astype(np.int32)),
        jnp.asarray(vals), block=64))
    np.testing.assert_array_equal(got, want_ref)     # integer values: exact
    np.testing.assert_array_equal(got, want_pallas)
    # float values, sorted positions: within rtol of the oracle
    fvals = rng.normal(0, 1, (b, s)).astype(np.float32)
    spos = np.sort(pos)
    got = _port_scatter_merge(table, spos, fvals)
    want = np.asarray(jref.scatter_merge_ref(
        jnp.asarray(table), jnp.asarray(spos.astype(np.int32)),
        jnp.asarray(fvals)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def _check_scatter_merge_empty_delta_is_a_no_op():
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    out = _port_scatter_merge(table, np.zeros((0,), np.int64),
                np.zeros((0, 3), np.float32))
    np.testing.assert_array_equal(out, table)


# ---------------------------------------------------------------- chunk sums
def _emulate_chunk_sums(vals):
    n, s = vals.shape
    nb = max(1, -(-n // 1024))
    parts = np.zeros((nb, s), np.float32)
    for c in range(nb):
        for col in range(s):
            buf = np.zeros(512, np.float32)
            for i in range(512):
                r0, r1 = c * 1024 + i, c * 1024 + i + 512
                a = vals[r0, col] if r0 < n else np.float32(0)
                b = vals[r1, col] if r1 < n else np.float32(0)
                buf[i] = np.float32(a + b)
            h = 256
            while h > 0:
                buf[:h] = buf[:h] + buf[h:2 * h]
                h //= 2
            parts[c, col] = buf[0]
    tot = parts[0].copy()
    for c in range(1, nb):
        tot = tot + parts[c]
    return parts, tot


def _port_chunk_sums_plain(vals):
    from repro_torch.kernels import segment_stats as ss
    parts, tot = ss.chunk_sums_plain(_t(vals))
    return parts.numpy(), tot.numpy()


def _port_chunked_sum(x):
    from repro_torch.kernels import segment_stats as ss
    return float(ss.chunked_sum(_t(x)))


def _check_chunk_sums_plain_matches_kernel_loop(n, s):
    rng = np.random.default_rng(n + 11 * s)
    vals = rng.normal(0, 100, (n, s)).astype(np.float32)
    parts, tot = _port_chunk_sums_plain(vals)
    want_parts, want_tot = _emulate_chunk_sums(vals)
    np.testing.assert_array_equal(parts.view(np.uint32),
                                  want_parts.view(np.uint32))
    np.testing.assert_array_equal(tot.view(np.uint32),
                                  want_tot.view(np.uint32))


def _check_chunked_sum_matches_reference_and_ignores_zero_padding(n):
    rng = np.random.default_rng(n)
    x = rng.normal(0, 10, n).astype(np.float32)
    got = _port_chunked_sum(x)
    np.testing.assert_allclose(got, float(j_chunked_sum(jnp.asarray(x))),
                               rtol=RTOL, atol=1e-3)
    np.testing.assert_allclose(got, float(np.sum(x.astype(np.float64))),
                               rtol=RTOL, atol=1e-3)
    # numpy chunk partials
    parts, _ = _port_chunk_sums_plain(x[:, None])
    pad = np.zeros(parts.shape[0] * 1024, np.float32)
    pad[:n] = x
    np.testing.assert_allclose(parts[:, 0],
                               pad.reshape(-1, 1024).sum(1), rtol=RTOL,
                               atol=1e-3)
    # bitwise invariant to any length of zero tail
    for extra in (1, 1000, 3000):
        padded = np.concatenate([x, np.zeros(extra, np.float32)])
        assert _port_chunked_sum(padded) == got


# The register-tree kernels (csrc/chunk_tree.cuh, chunk_sums.cu,
# logistic_grad.cu), emulated with numpy over whole arrays. Their constants:
CS_ONE_BLOCK_PAIRS = 64    # REPRO_CS_ONE_BLOCK_PAIRS: one block up to here
CS_WARPS = 16              # REPRO_CS_WARPS: warps a block above it
CS_TILE = 4096             # REPRO_CS_TILE: floats a combine buffer
NT_WARPS = 4               # REPRO_NT_WARPS: tiles (warps) a Newton block
NT_COMBINE = 256           # REPRO_NT_COMBINE: floats a pass-2 buffer


def _emulate_warp_tree(v):
    """``chunk_tree`` on v (..., 32, 32): v[..., a, l] is register a of
    lane l, row l + 32a of the chunk. Register steps pair a with a + h
    (h = 16 ... 1), then ``__shfl_down_sync`` by 16 ... 1 adds lane
    l + o's value to lane l (lanes past 32 - o read their own). Returns
    lane 0's value (...)."""
    v = v.copy()
    h = 16
    while h >= 1:
        v[..., :h, :] = v[..., :h, :] + v[..., h:2 * h, :]
        h //= 2
    x = v[..., 0, :]
    o = 16
    while o >= 1:
        x = x + np.concatenate([x[..., o:], x[..., 32 - o:]], axis=-1)
        o //= 2
    return x[..., 0]


def _emulate_chunk_pairs(mat):
    """``chunk_pairs`` over an (n, s) matrix: pair (chunk c, column col) by
    one warp, lane l loading rows 1024c + l + 32a (+0.0 past n). Returns
    the (nb, s) chunk sums."""
    n, s = mat.shape
    nb = max(1, -(-n // 1024))
    pad = np.zeros((nb * 1024, s), np.float32)
    pad[:n] = mat
    regs = pad.reshape(nb, 32, 32, s).transpose(0, 3, 1, 2)
    return _emulate_warp_tree(regs)


def _emulate_chunk_combine(parts, tile):
    """``chunk_combine``: columns in groups of 32 (lane c of warp 0 adds
    column c0 + c), rows staged ``(tile // w - 4) & ~3`` at a time; chunk
    0's value first, then every later chunk in order."""
    nb, s = parts.shape
    tot = np.zeros(s, np.float32)
    for c0 in range(0, s, 32):
        w = min(32, s - c0)
        rows = (tile // w - 4) & ~3
        t = None
        for k in range(-(-nb // rows)):
            buf = parts[k * rows:min(nb, (k + 1) * rows), c0:c0 + w]
            for r in range(buf.shape[0]):
                t = buf[r].copy() if t is None else t + buf[r]
        tot[c0:c0 + w] = t
    return tot


def _emulate_chunk_sums_kernel(vals, rng):
    """``chunk_sums_kernel`` as launched: the pairs dealt to the grid's
    warps, each written once into the (nb + 1, S) buffer (unwritten slots
    NaN, as ``torch.empty`` may hold anything), the blocks finishing in a
    random order; the one-block path combines after its barrier, the
    many-block path in the block that draws the last ticket."""
    n, s = vals.shape
    nb = max(1, -(-n // 1024))
    pairs = nb * s
    if pairs <= CS_ONE_BLOCK_PAIRS:
        blocks, warps = 1, max(2, min(pairs, 32))
    else:
        blocks, warps = min(-(-pairs // CS_WARPS), 1 << 16), CS_WARPS
    sums = _emulate_chunk_pairs(vals).reshape(-1)
    out = np.full((nb + 1) * s, np.nan, np.float32)
    ticket = 0
    for b in rng.permutation(blocks):
        for wp in range(warps):
            p = np.arange(b * warps + wp, pairs, blocks * warps)
            assert np.isnan(out[p]).all()   # each pair written once
            out[p] = sums[p]
        ticket += 1
    assert ticket == blocks and not np.isnan(out[:pairs]).any()
    out[pairs:] = _emulate_chunk_combine(out[:pairs].reshape(nb, s), CS_TILE)
    return out[:pairs].reshape(nb, s), out[pairs:]


def _emulate_newton_terms_kernel(X, t, m, w):
    """``newton_terms_kernel``: a warp per 1024-row tile, lane l owning rows
    l + 32a; the logit in ascending j, p from the plain version's
    ``torch.exp`` (the same call on the same (N,) tensor: only exp is free),
    r and s (0 past N, where X is staged as 0), then term by term the 32
    values a lane through ``chunk_tree``, stored term-major; pass 2: the
    tree over each 1024 tiles of every term, the group sums combined in
    order, g and the mirrored H. Returns (tile partials (n_tiles, Q), g,
    H)."""
    import torch
    n, d = X.shape
    q = d + d * (d + 1) // 2
    n_tiles = max(1, -(-n // 1024))
    z = np.zeros(n, np.float32)
    for j in range(d):
        z = z + X[:, j] * w[j]
    e = torch.exp(-torch.from_numpy(z)).numpy()
    p = np.float32(1.0) / (np.float32(1.0) + e)
    rows = n_tiles * 1024

    def regs(a):   # (rows,) -> (n_tiles, 32 registers, 32 lanes)
        return a.reshape(n_tiles, 32, 32)

    r = np.zeros(rows, np.float32)
    s = np.zeros(rows, np.float32)
    r[:n] = m * (p - t)
    s[:n] = (m * p) * (np.float32(1.0) - p)
    Xs = np.zeros((rows, d), np.float32)
    Xs[:n] = X
    terms = [regs(r) * regs(Xs[:, j]) for j in range(d)]
    terms += [(regs(s) * regs(Xs[:, j])) * regs(Xs[:, k])
              for j in range(d) for k in range(j, d)]
    part = _emulate_warp_tree(np.stack(terms, axis=1))     # (n_tiles, Q)
    assert part.shape == (n_tiles, q)
    term_major = np.ascontiguousarray(part.T)              # (Q, n_tiles)
    groups = _emulate_chunk_pairs(term_major.T)            # (groups, Q)
    tot = _emulate_chunk_combine(groups, NT_COMBINE)
    lo = np.minimum.outer(np.arange(d), np.arange(d))
    hi = np.maximum.outer(np.arange(d), np.arange(d))
    H = tot[d + lo * d - lo * (lo - 1) // 2 + (hi - lo)]
    return part, tot[:d], H


def _check_chunk_sums_kernel_order(n, s, rng):
    """The emulated kernel against ``chunk_sums_plain``, bit for bit; one
    column all -0.0 (with no +0.0 padding, N a multiple of 1024, its
    total stays -0.0), one of signed zeros and small integers (exact
    sums, many ties)."""
    from repro_torch.kernels import segment_stats as ss
    vals = rng.normal(0, 100, (n, s)).astype(np.float32)
    vals[:, 0] = -0.0
    if s > 1:
        vals[:, 1] = rng.choice(np.float32([-0.0, 0.0, 1.0, -1.0]), n)
    parts, tot = _emulate_chunk_sums_kernel(vals, rng)
    want_parts, want_tot = ss.chunk_sums_plain(_t(vals))
    np.testing.assert_array_equal(parts.view(np.uint32),
                                  want_parts.numpy().view(np.uint32))
    np.testing.assert_array_equal(tot.view(np.uint32),
                                  want_tot.numpy().view(np.uint32))
    if n % 1024 == 0:
        assert tot.view(np.uint32)[0] == np.float32(-0.0).view(np.uint32)


def _check_newton_terms_kernel_order(n, d, rng):
    """The emulated kernel against the plain version, bit for bit: its tile
    partials against ``chunk_sums_plain(newton_row_terms_plain(...))[0]``,
    g and H against ``logistic_newton_terms_plain``."""
    from repro_torch.kernels import logistic_grad as lg
    from repro_torch.kernels import segment_stats as ss
    X = rng.normal(0, 1.5, (n, d)).astype(np.float32)
    X[:, -1] = 1.0
    t = (rng.random(n) < 0.35).astype(np.float32)
    m = (rng.random(n) < 0.9).astype(np.float32)
    w = rng.normal(0, 0.7, d).astype(np.float32)
    part, g, H = _emulate_newton_terms_kernel(X, t, m, w)
    args = [_t(a) for a in (X, t, m, w)]
    want_part, _ = ss.chunk_sums_plain(lg.newton_row_terms_plain(*args))
    want_g, want_H = lg.logistic_newton_terms_plain(*args)
    for got, want in ((part, want_part), (g, want_g), (H, want_H)):
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.numpy().view(np.uint32))
    np.testing.assert_array_equal(H, H.T)


def _port_wrapper_raises_on_a_device_without_a_kernel():
    import torch
    from repro_torch.kernels import segment_stats as ss
    x = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError):
        ss.chunk_sums(x)


@pytest.fixture(autouse=True)
def _release_compiled_programs():
    """Drop the worker's compiled XLA programs before and after each test:
    they hold its memory maps (see the module docstring)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


# ----------------------------------------------------------------- the tests
def test_plain_versions_match_reference():
    """The kernel modules' plain versions against the reference: cem_keys
    against coarsen + pack, ``cem_keys_ref`` and the Pallas kernel; the
    segment sums, scatter merge and chunked sums against XLA, the oracles
    and the Pallas kernels; and the wrappers' device guard."""
    for n, d in ((1000, 5), (64, 1), (777, 7)):
        _check_cem_keys_plain_matches_reference(n, d)
    _check_cem_keys_matches_reference_op()
    for n, s, block in ((512, 4, 128), (300, 2, 128), (1024, 12, 256)):
        _check_segment_sums_matches_reference(n, s, block)
    for c, b, s in ((64, 256, 3), (32, 100, 5), (8, 0, 2)):
        _check_scatter_merge_matches_reference(c, b, s)
    _check_scatter_merge_empty_delta_is_a_no_op()
    for n in (100, 1024, 2500):
        _check_chunked_sum_matches_reference_and_ignores_zero_padding(n)
    _port_wrapper_raises_on_a_device_without_a_kernel()


def test_plain_versions_match_the_kernels_loops():
    """Each plain version bit for bit (as uint32) against a step-by-step
    emulation of its CUDA kernels: ragged sizes, long runs of one key, run
    lengths around the tile and window edges up to 65,537 rows, runs that
    start mid-window, dropped ids, -0.0 values, S = 1, 5, 6 and 12, and
    the kernel's tile as well as a small one."""
    for n, s, groups, inv in ((300, 3, 40, 0.3), (1000, 2, 7, 0.5),
                              (129, 4, 129, 0.0), (64, 1, 1, 0.9),
                              (5000, 12, 200, 0.4)):
        _check_segment_sums_plain_matches_kernel_loop(n, s, groups,
                                                      inv)
    for s in (1, 5, 6, 12):
        _check_segment_sums_run_lengths(s)
        _check_scatter_merge_run_lengths(s)
    for c, b, s in ((64, 200, 3), (16, 40, 12), (300, 7, 2), (4, 1500, 2)):
        _check_scatter_merge_plain_matches_kernel_loop(c, b, s)
    for n, s in ((1024, 2), (3000, 5), (1, 1), (5000, 1)):
        _check_chunk_sums_plain_matches_kernel_loop(n, s)


def test_register_tree_kernels_orders_match_plain():
    """The register-tree kernels of ``csrc/chunk_tree.cuh``, emulated step
    by step over whole arrays (lane / register layout, shuffles, the
    one-block and the ticket combine, the Newton kernel's warp-per-tile
    terms and its pass 2), bit for bit (as uint32) against the plain
    versions: ragged N, S = 1, 5, 14 and 40 (two column groups), chunk
    counts on both sides of the one-block limit and past one combine
    buffer; d = 1, 4, 9 and 64, and more than 1024 tiles (two groups in
    pass 2)."""
    rng = np.random.default_rng(18)
    for n, s in ((1, 1), (1023, 5), (1025, 14), (70001, 1), (70001, 5),
                 (70001, 14), (65536, 1), (65537, 1), (131072, 2),
                 (2049, 40), (300001, 14)):
        _check_chunk_sums_kernel_order(n, s, rng)
    for n, d in ((1, 1), (1023, 4), (1025, 9), (1023, 64), (70001, 4),
                 (70001, 9), (5000, 1), ((1 << 20) + 1500, 1)):
        _check_newton_terms_kernel_order(n, d, rng)
