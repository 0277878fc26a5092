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
                cutpoints=tab.cutpoints.numpy(), n_cuts=tab.n_cuts.tolist(),
                widths=tab.widths.tolist(),
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
def _tree(items):
    """The kernels' binary-counter pairwise sum of f32 items (tree_push
    then tree_fold in csrc/segment_sums.cu)."""
    stack = {}
    for r, carry in enumerate(items):
        k = 0
        while (r >> k) & 1:
            carry = np.float32(stack[k] + carry)
            k += 1
        stack[k] = carry
    acc = None
    for k in range(64):
        if (len(items) >> k) & 1:
            acc = stack[k] if acc is None else np.float32(stack[k] + acc)
    return acc


def _emulate_segment_sums(vals, perm, seg, g, tile):
    """The CUDA kernel's passes, step for step, in f32: per (segment,
    column) a pairwise sum over each ``tile`` rows (relative to the
    segment's first row), then a pairwise sum over the tile sums."""
    n, s = vals.shape
    out = np.zeros((g, s), np.float32)
    for sid in range(g):
        rows = np.flatnonzero(seg == sid)
        if rows.size == 0:
            continue
        for col in range(s):
            x = [np.float32(vals[perm[r], col]) for r in rows]
            out[sid, col] = _tree([_tree(x[k:k + tile])
                                   for k in range(0, len(x), tile)])
    return out


def _port_segment_sums_plain(vals, perm, seg, g):
    """The plain version, whether the CPU wrapper is it, and the kernels'
    tile."""
    import torch
    from repro_torch.kernels import segment_stats as ss
    got = ss.segment_sums_plain(_t(vals), _t(perm), _t(seg), g)
    wrapper = ss.segment_sums(_t(vals), _t(perm), _t(seg), g)
    return got.numpy(), bool(torch.equal(wrapper, got)), ss.SEGMENT_TILE


def _check_segment_sums_plain_matches_kernel_loop(n, s, groups, inv):
    rng = np.random.default_rng(n * s)
    vals = rng.normal(0, 1, (n, s)).astype(np.float32)
    seg, perm = _sorted_segments(rng, n, groups, inv)
    g = int(seg.max()) + 1
    got, wrapper_is_plain, kernel_tile = _port_segment_sums_plain(
        vals, perm, seg, g)
    # the kernel's tile, and a small one: the tree does not depend on it
    for tile in (kernel_tile, 4):
        want = _emulate_segment_sums(vals, perm, seg, g, tile)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    # the CPU wrapper is the plain version
    assert wrapper_is_plain


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
    """The CUDA kernel's passes in f32: each run of equal positions summed
    as tile trees then a tree over the tile sums, added onto the cell."""
    out = table.copy()
    b, s = vals.shape
    for p in np.unique(pos):
        if not 0 <= p < out.shape[0]:
            continue
        rows = np.flatnonzero(pos == p)
        for col in range(s):
            x = [np.float32(vals[r, col]) for r in rows]
            run = _tree([_tree(x[k:k + tile])
                         for k in range(0, len(x), tile)])
            out[p, col] = np.float32(out[p, col] + run)
    return out


def _port_scatter_merge_plain(table, pos, vals):
    from repro_torch.kernels import segment_stats as ss
    out = ss.scatter_merge_plain(_t(table.copy()), _t(pos), _t(vals))
    return out.numpy(), ss.SEGMENT_TILE


def _port_scatter_merge(table, pos, vals):
    from repro_torch.kernels import segment_stats as ss
    return ss.scatter_merge(_t(table.copy()), _t(pos), _t(vals)).numpy()


def _check_scatter_merge_plain_matches_kernel_loop(c, b, s):
    rng = np.random.default_rng(c + b)
    table = rng.normal(0, 5, (c, s)).astype(np.float32)
    vals = rng.normal(0, 1, (b, s)).astype(np.float32)
    # non-decreasing positions with runs of duplicates, like the fast path
    pos = np.sort(rng.integers(0, c, b)).astype(np.int64)
    pos[-max(1, b // 5):] = c - 1            # the invalid-row tail
    got, kernel_tile = _port_scatter_merge_plain(table, pos, vals)
    for tile in (kernel_tile, 4):
        want = _emulate_scatter_merge(table, pos, vals, tile)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


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
    """Each plain version bit for bit against a step-by-step emulation of
    its CUDA kernel's loop: ragged sizes, long runs of one key, and the
    kernel's tile as well as a small one."""
    for n, s, groups, inv in ((300, 3, 40, 0.3), (1000, 2, 7, 0.5),
                              (129, 4, 129, 0.0), (64, 1, 1, 0.9)):
        _check_segment_sums_plain_matches_kernel_loop(n, s, groups,
                                                      inv)
    for c, b, s in ((64, 200, 3), (16, 40, 12), (300, 7, 2), (4, 1500, 2)):
        _check_scatter_merge_plain_matches_kernel_loop(c, b, s)
    for n, s in ((1024, 2), (3000, 5), (1, 1), (5000, 1)):
        _check_chunk_sums_plain_matches_kernel_loop(n, s)
