"""The coarsen + pack kernel's column route on the CPU: a batch's columns
in every dtype the kernel reads, at any stride, through
``repro_torch.kernels.cem_keys.cem_keys_cols`` (and the engine's
``ops.cem_keys_columns``), held exactly against the reference —
``coarsen`` + ``KeyCodec.pack``, the oracle ``cem_keys_ref`` and the
Pallas kernel in interpret mode (``cem_keys_op``) — on the columns
converted to f32 by numpy (round to nearest even, as
``Tensor.to(torch.float32)`` and the kernel's ``__*2float_rn``
intrinsics convert). Also a numpy emulation of the kernel's 64-bit
packing, the matrix form against the column form, and the refusals,
which are the same on every device.

The values stress the conversion: ints around 2^24 and 2^31 - 1, f64
values halfway between f32 neighbours, +-0.0, +-inf and NaN, against
cutpoints placed where rounding to nearest even and truncation give
other buckets. ``coarsen``'s ``searchsorted`` puts NaN above every
cutpoint while both kernels count no cutpoint for it, so rows holding a
NaN are held against the two kernel references only.

The card's cases (the kernel against this plain route, bitwise) are in
``tests/test_torch_cuda.py``.
"""
import ml_dtypes
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from repro.core.coarsen import CoarsenSpec as JSpec
from repro.core.coarsen import coarsen as jcoarsen
from repro.core.keys import KeyCodec as JCodec
from repro.kernels import cem_keys_op as j_cem_keys_op
from repro.kernels import ref as jref

INF = float("inf")
# cutpoints where the rounding of an int or f64 element decides the bucket
_I24 = 1 << 24
INT_CUTS = (-2.0, 0.0, float(_I24), float(_I24 + 4), 2147483520.0,
            2147483648.0)


def _halfway(rng, n):
    """f64 values halfway between f32 neighbours (either side's mantissa
    even), a hair above and below them, and the f32 neighbours (the
    cutpoints)."""
    pool = np.sort(rng.normal(0, 4, 6).astype(np.float32))
    a = rng.choice(pool, n)
    b = np.nextafter(a, np.float32(INF))
    mid = (a.astype(np.float64) + b.astype(np.float64)) / 2
    pick = rng.integers(0, 3, n)
    x = np.where(pick == 0, mid, np.where(pick == 1, np.nextafter(mid, INF),
                                          np.nextafter(mid, -INF)))
    return x, sorted(set(pool.tolist())
                     | set(np.nextafter(pool, np.float32(INF)).tolist()))


def _special(rng, x, frac=0.05):
    """Replace a fraction of a float column with +-0.0, +-inf and NaN."""
    x = x.copy()
    at = rng.random(x.shape[0]) < frac
    x[at] = rng.choice(np.array([0.0, -0.0, INF, -INF, np.nan], x.dtype),
                       int(at.sum()))
    return x


def _mixed_columns(rng, n):
    """(numpy columns, kernel cutpoints per column, reference spec per
    column): one column of every dtype the kernel reads."""
    near_i24 = _I24 + rng.integers(-6, 7, n)
    near_i31 = 2147483647 - rng.integers(0, 200, n)
    ints = np.where(rng.random(n) < 0.5, near_i24, near_i31)
    ints[rng.random(n) < 0.1] *= -1
    h64, h_cuts = _halfway(rng, n)
    f32 = _special(rng, rng.normal(0, 3, n).astype(np.float32))
    f16 = _special(rng, rng.normal(0, 3, n).astype(np.float16))
    bf16 = rng.normal(0, 3, n).astype(np.float32).astype(ml_dtypes.bfloat16)
    cols = {
        "a_f32": (f32, sorted(rng.normal(0, 2, 5).tolist() + [0.0])),
        "b_f64": (_special(rng, h64, 0.02), h_cuts),
        "c_i32": (ints.astype(np.int32), list(INT_CUTS)),
        "d_i64": (np.where(rng.random(n) < 0.5, ints,
                           ints * 4 + 1).astype(np.int64),
                  list(INT_CUTS) + [float(1 << 33)]),
        "e_i16": (rng.integers(-32768, 32768, n).astype(np.int16),
                  [-1000.0, 0.0, 7.0, 20000.0]),
        "f_u8": (rng.integers(0, 12, n).astype(np.uint8), 12),
        "g_bool": (rng.random(n) < 0.4, 2),
        "h_f16": (f16, [-1.5, -0.0, 0.5, 3.25]),
        "i_i8": (rng.integers(0, 5, n).astype(np.int8), 5),
        "j_bf16": (bf16, [-1.0, 0.0, 1.0, 2.5]),
        # a float column on the integer grid 1..9 (a categorical spec's
        # cutpoints), with halves, +-0.0, +-inf and NaN
        "k_f32": (_special(rng, (rng.integers(-4, 24, n) / 2).astype(
            np.float32), 0.1), [float(k) for k in range(1, 10)]),
    }
    return cols


def _torch_column(a):
    import torch
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _specs(cols):
    """Port and reference specs: an int cardinality is a categorical spec,
    a list the cutpoints of a continuous one."""
    from repro_torch.core.coarsen import CoarsenSpec
    port, ref = {}, {}
    for k, (_, s) in cols.items():
        if isinstance(s, int):
            port[k], ref[k] = CoarsenSpec.categorical(s), JSpec.categorical(s)
        else:
            port[k] = CoarsenSpec.from_cutpoints(s)
            ref[k] = JSpec.from_cutpoints(s)
    return port, ref


def _strided(t, rng, how):
    """The same column at another stride: a slice of a larger buffer or a
    column of a row-major matrix."""
    import torch
    n = t.shape[0]
    if how == "slice":
        big = torch.zeros((3 * n,), dtype=t.dtype)
        big[1::3] = t
        return big[1::3]
    if how == "matrix":
        m = torch.zeros((n, 3), dtype=t.dtype)
        m[:, 2] = t
        return m[:, 2]
    return t


def _port_keys(columns, valid, table):
    """The engine's call (``ops.cem_keys_columns``) and the kernel
    module's (``cem_keys_cols``): they must agree."""
    import torch
    from repro_torch.kernels import cem_keys as ck
    from repro_torch.kernels.ops import cem_keys_columns
    hi, lo = cem_keys_columns(columns, valid, table)
    h2, l2 = ck.cem_keys_cols([columns[k] for k in table.names], valid,
                              table.cutpoints, table.n_cuts, table.widths)
    assert torch.equal(hi, h2) and torch.equal(lo, l2)
    return hi.numpy(), lo.numpy()


def _emulate_kernel(X, valid, cuts, widths):
    """csrc/cem_keys.cu's count and packing in numpy: each column's real
    cutpoints padded with NaN to a multiple of 4 (no x is >= NaN, +inf
    included), the bucket the count of the padded row's entries <= x (x
    the f32 element; for cutpoints 1, 2, ..., m the kernel's closed form,
    which must agree), shifted into one 64-bit key, then split into (hi,
    lo); invalid rows get 0xFFFFFFFF twice."""
    key = np.zeros(X.shape[0], np.uint64)
    for j, (c, w) in enumerate(zip(cuts, widths)):
        if w == 0:
            continue
        row = np.full(-(-len(c) // 4) * 4, np.nan, np.float32)
        row[:len(c)] = c
        b = (X[:, j:j + 1] >= row[None, :]).sum(1)
        if list(c) == list(range(1, len(c) + 1)):
            # the integer grid's closed form: min(floor(x), m) for x >= 1
            x = X[:, j]
            with np.errstate(invalid="ignore"):
                g = np.where(x >= 1, np.minimum(np.floor(x), len(c)), 0)
            np.testing.assert_array_equal(g.astype(np.int64), b)
        key = (key << np.uint64(w)) | b.astype(np.uint64)
    hi = np.where(valid, key >> np.uint64(32), 0xFFFFFFFF).astype(np.int64)
    lo = np.where(valid, key & np.uint64(0xFFFFFFFF),
                  0xFFFFFFFF).astype(np.int64)
    return hi, lo


def _check_against_reference(cols, valid, strides, rng):
    """The column route on ``cols`` (numpy, reference specs in ``cols``)
    held exactly against coarsen + pack (rows without NaN), cem_keys_ref,
    the Pallas kernel and the kernel's packing."""
    from repro_torch.core.keys import KeyCodec
    from repro_torch.kernels.ops import CutpointTable
    pspecs, jspecs = _specs(cols)
    codec = KeyCodec.from_cardinalities(
        {k: s.n_buckets for k, s in pspecs.items()})
    jcodec = JCodec.from_cardinalities(
        {k: s.n_buckets for k, s in jspecs.items()})
    assert codec.names == jcodec.names
    table = CutpointTable.for_codec(codec, pspecs, "cpu")
    columns = {k: _strided(_torch_column(a), rng, strides[i % len(strides)])
               for i, (k, (a, _)) in enumerate(cols.items())}
    hi, lo = _port_keys(columns, _torch_column(valid), table)
    # the reference's input: every column converted to f32 by numpy
    X = np.stack([cols[k][0].astype(np.float32) for k in codec.names], 1) \
        if codec.names else np.zeros((valid.shape[0], 0), np.float32)
    kcuts = [pspecs[k].kernel_cutpoints() for k in codec.names]
    widths = list(table.widths)
    # 1: coarsen + KeyCodec.pack, on the rows without NaN
    jb = {k: jcoarsen(jnp.asarray(X[:, j]), jspecs[k])
          for j, k in enumerate(codec.names)}
    wh, wl = jcodec.pack(jb, jnp.asarray(valid))
    ok = ~np.isnan(X).any(1)
    np.testing.assert_array_equal(hi[ok], np.asarray(wh)[ok])
    np.testing.assert_array_equal(lo[ok], np.asarray(wl)[ok])
    # 2: the oracle on the padded table; 3: the Pallas kernel
    rh, rl = jref.cem_keys_ref(jnp.asarray(X),
                               jnp.asarray(table.cutpoints.numpy()),
                               list(table.n_cuts), widths,
                               jnp.asarray(valid))
    np.testing.assert_array_equal(hi, np.asarray(rh))
    np.testing.assert_array_equal(lo, np.asarray(rl))
    if valid.shape[0]:
        ph, pl = j_cem_keys_op(jnp.asarray(X), kcuts, widths,
                               jnp.asarray(valid), block=128)
        np.testing.assert_array_equal(hi, np.asarray(ph))
        np.testing.assert_array_equal(lo, np.asarray(pl))
    # 4: the kernel's 64-bit packing
    eh, el = _emulate_kernel(X, valid, kcuts, widths)
    np.testing.assert_array_equal(hi, eh)
    np.testing.assert_array_equal(lo, el)
    return int(sum(widths))


@pytest.fixture(autouse=True)
def _drop_compiled_programs():
    """Free the worker's compiled reference programs before and after:
    they hold its memory maps (``tests/test_torch_kernels.py``)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_column_route_matches_reference():
    """Mixed dtypes (f32, f64, f16, bf16, i64, i32, i16, i8, u8, bool)
    contiguous and strided; n = 0; d = 1 (a float and an int column); the
    widest key (nine 7-bit fields: 63 bits)."""
    rng = np.random.default_rng(19)
    n = 1500
    cols = _mixed_columns(rng, n)
    valid = rng.random(n) > 0.15
    _check_against_reference(cols, valid, ("contiguous",), rng)
    _check_against_reference(cols, valid, ("slice", "matrix", "contiguous"),
                             rng)
    _check_against_reference({k: (a[:0], s) for k, (a, s) in cols.items()},
                             valid[:0], ("slice",), rng)
    for name in ("b_f64", "d_i64", "f_u8"):
        _check_against_reference({name: cols[name]}, valid, ("matrix",), rng)
    wide = {f"w{j}": (rng.normal(0, 2, n).astype(
        (np.float32, np.float64, np.int32)[j % 3]) * (1 + 40 * (j % 3)),
        sorted(rng.normal(0, 40, 127).tolist())) for j in range(9)}
    assert _check_against_reference(wide, valid, ("contiguous", "slice"),
                                     rng) == 63


def test_column_route_matrix_form_and_refusals():
    """The matrix form equals the column form on the same f32 columns (also
    a transposed, strided X), a 32-bit field included; the column route
    refuses, on the CPU as on the card, what the kernel does not take."""
    import torch
    from repro_torch.kernels import cem_keys as ck
    from repro_torch.kernels.ops import CutpointTable
    rng = np.random.default_rng(20)
    n = 700
    X = torch.from_numpy(rng.normal(0, 3, (n, 4)).astype(np.float32))
    valid = torch.from_numpy(rng.random(n) > 0.2)
    cuts = [sorted(rng.normal(0, 2, k).tolist()) for k in (3, 1, 6, 2)]
    for widths in ((2, 1, 3, 2), (32, 1, 28, 2)):
        tab = CutpointTable.build(cuts, widths, "abcd", "cpu")
        for M in (X, X.t().contiguous().t()):
            mh, ml = ck.cem_keys(M, tab.cutpoints, tab.n_cuts, tab.widths,
                                 valid)
            ch, cl = ck.cem_keys_cols(M.unbind(1), valid, tab.cutpoints,
                                      tab.n_cuts, tab.widths, tab.fields)
            assert torch.equal(mh, ch) and torch.equal(ml, cl)
            # int tensors for the counts and widths give the same keys
            th, tl = ck.cem_keys(M, tab.cutpoints, torch.tensor(tab.n_cuts),
                                 torch.tensor(tab.widths), valid)
            assert torch.equal(mh, th) and torch.equal(ml, tl)
        eh, el = _emulate_kernel(X.numpy(), valid.numpy(), cuts, widths)
        np.testing.assert_array_equal(mh.numpy(), eh)
        np.testing.assert_array_equal(ml.numpy(), el)
    assert ck.fields(tab.n_cuts, tab.widths) == tab.fields
    cols = list(X.unbind(1))
    args = (tab.cutpoints, tab.n_cuts, (2, 1, 3, 2))
    one = torch.zeros((n,))
    refusals = [
        # more columns than the launch's struct holds
        (ValueError, [one] * 65, valid, torch.full((65, 1), INF), (0,) * 65,
         (0,) * 65),
        # a key wider than 63 bits, a field wider than 32
        (ValueError, cols, valid, tab.cutpoints, tab.n_cuts, (16,) * 4),
        (ValueError, cols, valid, tab.cutpoints, tab.n_cuts, (33, 1, 1, 1)),
        # a column on another device, of another length, not 1-D
        (ValueError, cols[:3] + [one.to("meta")], valid, *args),
        (ValueError, cols[:3] + [one[:-1]], valid, *args),
        (ValueError, cols[:3] + [X[:, :2]], valid, *args),
        # a dtype the kernel does not read, for a column or the mask
        (TypeError, cols[:3] + [one.to(torch.complex64)], valid, *args),
        (TypeError, cols[:3] + [one.to(torch.uint16)], valid, *args),
        (TypeError, cols, valid.to(torch.complex64), *args),
        # the cut table: another dtype, too few columns or cutpoints
        (TypeError, cols, valid, tab.cutpoints.double(), tab.n_cuts,
         (2, 1, 3, 2)),
        (ValueError, cols, valid, tab.cutpoints[:3], tab.n_cuts,
         (2, 1, 3, 2)),
        (ValueError, cols, valid, tab.cutpoints[:, :2], tab.n_cuts,
         (2, 1, 3, 2)),
        (ValueError, cols, valid, tab.cutpoints, tab.n_cuts[:3],
         (2, 1, 3, 2)),
    ]
    for i, (err, *call) in enumerate(refusals):
        with pytest.raises(err):
            ck.cem_keys_cols(*call)
    # a cutpoint table checks its per-codec part once, when it is built
    with pytest.raises(ValueError):
        CutpointTable.build(cuts, (16,) * 4, "abcd", "cpu")
    # a column of stride 0 (an expanded scalar) reads its one element
    wide = torch.tensor(1.25).expand(n)
    h1, l1 = ck.cem_keys_cols(cols[:3] + [wide], valid, *args)
    h2, l2 = ck.cem_keys_cols(cols[:3] + [wide.contiguous()], valid, *args)
    assert wide.stride(0) == 0
    assert torch.equal(h1, h2) and torch.equal(l1, l2)
    # a non-bool mask of any dtype the kernel reads is Tensor.to(bool)
    fmask = torch.where(valid, torch.tensor(float("nan")), torch.tensor(-0.0))
    h1, l1 = ck.cem_keys_cols(cols, fmask, *args)
    h2, l2 = ck.cem_keys_cols(cols, valid, *args)
    assert torch.equal(h1, h2) and torch.equal(l1, l2)
