"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without a CUDA device;
the file imports torch, numpy and ``repro_torch`` only (no JAX), so it
runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel pins its summation order to its plain version's, so every
comparison is bitwise.
"""
import numpy as np
import pytest

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


def _t(a, dev):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _case_cem_keys_matches_plain():
    import torch
    from repro_torch.kernels import cem_keys as ck
    from repro_torch.kernels.ops import CutpointTable
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = (1 << 16) + 37
    X = _t(rng.normal(0, 3, (n, 7)).astype(np.float32), dev)
    valid = _t(rng.random(n) > 0.1, dev)
    tab = CutpointTable.build([sorted(rng.normal(0, 2, k).tolist())
                               for k in (1, 3, 5, 2, 15, 4, 4)],
                              [1, 2, 3, 2, 4, 3, 3], "abcdefg", dev)
    args = (X, tab.cutpoints, tab.n_cuts, tab.widths, valid)
    before = ck.KERNEL.launches
    kh, kl = ck.cem_keys(*args)
    assert ck.KERNEL.launches == before + 1
    ph, pl = ck.cem_keys_plain(*args)
    assert torch.equal(kh, ph) and torch.equal(kl, pl)


# the dtypes the column route reads natively (``cem_keys.DTYPES``)
CEM_DTYPES = ("float32", "float64", "float16", "bfloat16", "int64", "int32",
              "int16", "int8", "uint8", "bool")


def _cem_columns(rng, n, dev, how):
    """One column of every dtype the kernel reads, on ``dev``: ints around
    2^24 and 2^31 - 1, f64 values halfway between f32 neighbours, +-0.0,
    +-inf and NaN; with cutpoints where the rounding decides the bucket.
    ``how``: contiguous, a slice of a larger buffer (stride 3) or a column
    of a row-major matrix (stride 2). Returns (columns, cut lists)."""
    import torch
    ints = np.where(rng.random(n) < 0.5, (1 << 24) + rng.integers(-6, 7, n),
                    2147483647 - rng.integers(0, 200, n))
    pool = np.sort(rng.normal(0, 4, 6).astype(np.float32))
    a = rng.choice(pool, n).astype(np.float64)
    b = np.nextafter(a.astype(np.float32), np.float32(np.inf))
    half = (a + b.astype(np.float64)) / 2
    floats = rng.normal(0, 3, n)
    at = rng.random(n) < 0.05
    floats[at] = rng.choice([0.0, -0.0, np.inf, -np.inf, np.nan],
                            int(at.sum()))
    int_cuts = [-2.0, 0.0, 16777216.0, 16777220.0, 2147483520.0,
                2147483648.0]
    spec = {
        "float32": (floats, sorted(rng.normal(0, 2, 5).tolist() + [0.0])),
        "float64": (np.where(rng.random(n) < 0.9, half, floats),
                    sorted(set(pool.tolist()) | set(
                        np.nextafter(pool, np.float32(np.inf)).tolist()))),
        # the integer grid 1, 2, 3: the kernel's closed-form count
        "float16": (np.where(rng.random(n) < 0.5, floats,
                             rng.integers(-2, 9, n) / 2), [1.0, 2.0, 3.0]),
        "bfloat16": (floats, [-1.0, 0.0, 1.0, 2.5]),
        "int64": (ints * np.where(rng.random(n) < 0.5, 1, -4),
                  int_cuts + [float(1 << 33)]),
        "int32": (ints * np.where(rng.random(n) < 0.9, 1, -1), int_cuts),
        "int16": (rng.integers(-32768, 32768, n), [-1000.0, 0.0, 7.0]),
        "int8": (rng.integers(-128, 128, n), [-3.0, 0.0, 1.0, 100.0]),
        "uint8": (rng.integers(0, 256, n), [float(c) for c in range(1, 16)]),
        "bool": (rng.random(n) < 0.4, [1.0]),
    }
    cols, cuts = {}, []
    for name in CEM_DTYPES:
        vals, c = spec[name]
        dt = getattr(torch, name)
        # ints exactly, the rest through f64 (bool, f16, bf16 on the card)
        exact = np.asarray(vals, np.int64 if "int" in name else np.float64)
        t = torch.from_numpy(exact).to(dev).to(dt)
        if how == "slice":
            big = torch.zeros((3 * n,), dtype=dt, device=dev)
            big[1::3] = t
            t = big[1::3]
        elif how == "matrix":
            m = torch.zeros((n, 2), dtype=dt, device=dev)
            m[:, 1] = t
            t = m[:, 1]
        cols[name] = t
        cuts.append(c)
    return cols, cuts


def _case_cem_keys_column_route():
    """The column route (``ops.cem_keys_columns``) on the card bitwise its
    plain version over the stacked f32 columns, every dtype the kernel
    reads, contiguous and strided, at n = 1, 2^18 + 3 (one pass of the
    grid) and 2^21 + 5 (the grid strides); one launch, no host read and no
    device op but the kernel per call; the matrix form equal to the column
    form; the refusals of the wrapper and of the C entry."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import cem_keys as ck
    from repro_torch.kernels.ops import CutpointTable, cem_keys_columns
    dev = torch.device("cuda")
    rng = np.random.default_rng(19)
    widths = [3, 4, 3, 3, 4, 3, 2, 3, 4, 1]
    for n in (1, (1 << 18) + 3, (1 << 21) + 5):
        for how in ("contiguous", "slice", "matrix"):
            cols, cuts = _cem_columns(rng, n, dev, how)
            tab = CutpointTable.build(cuts, widths, CEM_DTYPES, dev)
            valid = _t(rng.random(n) > 0.1, dev)
            before = ck.KERNEL.launches
            hi, lo = cem_keys_columns(cols, valid, tab)
            assert ck.KERNEL.launches == before + 1
            X = torch.stack([cols[c].to(torch.float32) for c in CEM_DTYPES],
                            1)
            ph, pl = ck.cem_keys_plain(X, tab.cutpoints, tab.n_cuts,
                                       tab.widths, valid)
            assert torch.equal(hi, ph) and torch.equal(lo, pl), (n, how)
            # the matrix form: X's columns as strided views, same kernel
            mh, ml = ck.cem_keys(X, tab.cutpoints, tab.n_cuts, tab.widths,
                                 valid)
            assert torch.equal(mh, ph) and torch.equal(ml, pl), (n, how)
    # a float mask is read as Tensor.to(bool) (NaN true, -0.0 false)
    fmask = torch.where(valid, torch.tensor(float("nan"), device=dev),
                        torch.tensor(-0.0, device=dev))
    fh, fl = cem_keys_columns(cols, fmask, tab)
    assert torch.equal(fh, hi) and torch.equal(fl, lo)
    # one kernel a call: no torch op that runs on the card, no host read
    before = ck.KERNEL.launches
    ops = _torch_ops(lambda: cem_keys_columns(cols, valid, tab))
    assert ck.KERNEL.launches == before + 2
    assert set(ops) <= NO_DEVICE_WORK, ops
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cem_keys_columns(cols, valid, tab)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # the launch reads PyTorch's current stream, a side stream included
    get_device, raw_stream = build._cuda_hooks()
    assert raw_stream(get_device()) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert raw_stream(get_device()) == side.cuda_stream
    # refusals: a column on the host, a key over 63 bits, 65 columns
    names = list(CEM_DTYPES)
    with pytest.raises(ValueError):
        ck.cem_keys_cols([cols[c] for c in names[:-1]] + [cols["bool"].cpu()],
                         valid, tab.cutpoints, tab.n_cuts, tab.widths)
    with pytest.raises(ValueError):
        ck.cem_keys_cols([cols[c] for c in names], valid, tab.cutpoints,
                         tab.n_cuts, (7,) * 10)
    one = cols["float32"]
    with pytest.raises(ValueError):
        ck.cem_keys_cols([one] * 65, valid,
                         torch.full((65, 1), float("inf"), device=dev),
                         (0,) * 65, (0,) * 65)
    # the C entry refuses a field over 32 bits: Kernel.launch raises and
    # counts nothing
    out = torch.empty((2, n), dtype=torch.int64, device=dev)
    call = ck.struct.pack("=12q", out.data_ptr(), out.data_ptr() + 8 * n,
                          tab.cutpoints.data_ptr(), valid.data_ptr(), 1,
                          ck.DTYPES[torch.bool], n, 1,
                          tab.cutpoints.shape[1], one.data_ptr(), 1, 0)
    before = ck.KERNEL.launches
    with pytest.raises(RuntimeError, match="failed to launch"):
        ck.KERNEL.launch(dev, call, ck.struct.pack("=2i", 3, 33))
    assert ck.KERNEL.launches == before
    ck.KERNEL.launch(dev, call, ck.fields((3,), (32,)))
    assert ck.KERNEL.launches == before + 1
    torch.cuda.synchronize()


def _bits(x):
    """A float tensor's bits: ``torch.equal`` takes -0.0 for +0.0."""
    import torch
    return x.contiguous().view(torch.int32)


def _case_segment_sums_matches_plain(n_groups, invalid, s=12):
    import torch
    from repro_torch.kernels import segment_stats as ss
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    n = (1 << 16) + 5
    n_inv = int(n * invalid)
    seg = np.sort(rng.integers(0, n_groups, n - n_inv))
    _, seg = np.unique(seg, return_inverse=True)
    seg = np.concatenate([seg, np.full(n_inv, seg.max() + 1)])
    perm = rng.permutation(n)
    vals = _t(rng.normal(0, 1, (n, s)).astype(np.float32), dev)
    args = (vals, _t(perm.astype(np.int64), dev),
            _t(seg.astype(np.int64), dev), n)
    assert torch.equal(_bits(ss.segment_sums(*args)),
                       _bits(ss.segment_sums_plain(*args)))


# run lengths around the tile (256 rows) and window edges, one of 65,537
# rows, and one of 2^20 (an offline subclass's size)
RUN_LENGTHS = (1, 2, 255, 256, 257, 511, 512, 513, 3, 65537, 1, 300)


def _runs(rng, s, lengths=RUN_LENGTHS):
    """Segment ids: a 37-row run, then ``lengths`` shuffled (each later run
    starts mid-window), five -1 rows after the fourth run (dropped ids
    between kept ones) and a 40-row dropped tail; values with -0.0
    scattered, a one-row run and a 257-row run (where there is one) of
    -0.0. Returns (seg, vals, kept id count)."""
    lengths = [37] + list(rng.permutation(lengths))
    seg, sid = [], 0
    for i, length in enumerate(lengths):
        seg += [sid] * int(length)
        sid += 1
        if i == 3:
            seg += [-1] * 5
    seg = np.asarray(seg + [sid] * 40, np.int64)
    n = seg.shape[0]
    vals = rng.normal(0, 1, (n, s)).astype(np.float32)
    vals[rng.random((n, s)) < 0.05] = np.float32(-0.0)
    starts = np.flatnonzero(np.r_[True, seg[1:] != seg[:-1]])
    lens = np.diff(np.r_[starts, n])
    for length in (1, 257):
        if (lens == length).any():
            z = starts[lens == length][0]
            vals[z:z + length] = np.float32(-0.0)
    return seg, vals, sid


def _case_segment_sums_run_lengths(s, lengths=RUN_LENGTHS, unaligned=False):
    """Runs of every length around the tile and window edges, gathered
    through a random permutation; ``unaligned``: the values are a view
    4 bytes past a 16-byte boundary (``x[1:]`` of a flat buffer). Bit for
    bit, one launch per call."""
    import torch
    from repro_torch.kernels import segment_stats as ss
    dev = torch.device("cuda")
    rng = np.random.default_rng(10 + s + len(lengths))
    seg, vals, g = _runs(rng, s, lengths)
    n = seg.shape[0]
    perm = rng.permutation(n).astype(np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    x = _t(vals[inv], dev)
    if unaligned:
        flat = torch.empty((n * s + 1,), dtype=torch.float32, device=dev)
        flat[1:] = x.reshape(-1)
        x = flat[1:].view(n, s)
        assert x.data_ptr() % 16 == 4
    args = (x, _t(perm, dev), _t(seg, dev), g)
    before = ss.SEGMENT_SUMS.launches
    got = ss.segment_sums(*args)
    assert ss.SEGMENT_SUMS.launches == before + 1
    assert torch.equal(_bits(got), _bits(ss.segment_sums_plain(*args)))
    if 1 in lengths:      # a -0.0 row's segment is -0.0, not the fill's +0.0
        assert bool((_bits(got) == np.int32(-2 ** 31)).any())


def _case_scatter_merge_matches_plain():
    import torch
    from repro_torch.kernels import segment_stats as ss
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    c, b, s = 50000, 20000, 12
    table = _t(rng.normal(0, 5, (c, s)).astype(np.float32), dev)
    pos = np.sort(rng.integers(0, c, b)).astype(np.int64)
    pos[-1000:] = c - 1                  # the invalid-row tail: one long run
    vals = _t(rng.normal(0, 1, (b, s)).astype(np.float32), dev)
    pos = _t(pos, dev)
    got = ss.scatter_merge(table.clone(), pos, vals)
    assert torch.equal(_bits(got),
                       _bits(ss.scatter_merge_plain(table.clone(), pos,
                                                    vals)))
    # an empty delta launches nothing and leaves the table as it was
    before = ss.SCATTER_MERGE.launches
    out = ss.scatter_merge(table.clone(), pos[:0], vals[:0])
    assert torch.equal(_bits(out), _bits(table))
    assert ss.SCATTER_MERGE.launches == before


def _case_scatter_merge_run_lengths(s, unaligned=False):
    """Runs of duplicate positions of every length around the tile and
    window edges, positions below 0 and past the table (dropped), -0.0 in
    the delta and the table; bit for bit, one launch."""
    import torch
    from repro_torch.kernels import segment_stats as ss
    dev = torch.device("cuda")
    rng = np.random.default_rng(20 + s)
    seg, vals, g = _runs(rng, s)
    pos = np.maximum.accumulate(seg)        # the -1 rows join the run before
    c = g + 3
    pos = np.where(pos >= g, c + 2, pos + 2)
    pos[:3] = -1
    table = rng.normal(0, 5, (c, s)).astype(np.float32)
    table[rng.random((c, s)) < 0.2] = np.float32(-0.0)
    table, pos = _t(table, dev), _t(pos.astype(np.int64), dev)
    x = _t(vals, dev)
    if unaligned:
        n = x.shape[0]
        flat = torch.empty((n * s + 1,), dtype=torch.float32, device=dev)
        flat[1:] = x.reshape(-1)
        x = flat[1:].view(n, s)
    before = ss.SCATTER_MERGE.launches
    got = ss.scatter_merge(table.clone(), pos, x)
    assert ss.SCATTER_MERGE.launches == before + 1
    assert torch.equal(_bits(got),
                       _bits(ss.scatter_merge_plain(table.clone(), pos, x)))


# device operations per call (PERF.md): segment_sums zero-fills its output
# and launches the tile pass and the fold; scatter_merge launches the two;
# scatter_merge_parts adds its slot pass
DEVICE_OPS = {"segment_sums": 3, "scatter_merge": 2, "scatter_merge_parts": 3}


def _device_ops(fn):
    """Device operations (kernels, memsets, copies) one call of ``fn``
    issues, by name, as the profiler records them (after one warm-up
    call). A window in which the profiler recorded no device activity at
    all (it happens now and then for a window of one call, ``PERF.md``
    §7) is profiled again, at most twice, as ``chip_smoke.py`` does."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
        if ops:
            break
    return ops


def _case_tree_kernels_device_ops_and_empty_inputs():
    """Each tree kernel's device operations per call, as DEVICE_OPS states;
    no launch for an empty input."""
    import torch
    from repro_torch.kernels import segment_stats as ss
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    n, s, c = 5000, 12, 3000
    vals = _t(rng.normal(0, 1, (n, s)).astype(np.float32), dev)
    perm = _t(rng.permutation(n).astype(np.int64), dev)
    pos = torch.sort(_t(rng.integers(0, c, n).astype(np.int64), dev)).values
    table = torch.zeros((c, s), device=dev)
    tables = torch.zeros((4, c, s), device=dev)
    ppos = torch.sort(_t(rng.integers(0, c, (4, n)).astype(np.int64), dev),
                      dim=1).values
    pvals = _t(rng.normal(0, 1, (4, n, s)).astype(np.float32), dev)
    got = {
        "segment_sums": _device_ops(lambda: ss.segment_sums(vals, perm, pos,
                                                            c)),
        "scatter_merge": _device_ops(lambda: ss.scatter_merge(table, pos,
                                                              vals)),
        "scatter_merge_parts": _device_ops(
            lambda: ss.scatter_merge_parts(tables, ppos, pvals)),
    }
    assert {k: sum(v.values()) for k, v in got.items()} == DEVICE_OPS, got
    before = dict(ss.build.launch_counts())
    out = ss.segment_sums(vals[:0], perm[:0], pos[:0], c)
    assert out.shape == (c, s) and not bool(out.any())
    ss.scatter_merge_parts(tables, ppos[:, :0], pvals[:, :0])
    assert ss.build.launch_counts() == before


def _case_chunk_sums_matches_plain(n):
    import torch
    from repro_torch.kernels import segment_stats as ss
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    vals = _t(rng.normal(0, 100, (n, 5)).astype(np.float32), dev)
    kp, kt = ss.chunk_sums(vals)
    pp, pt = ss.chunk_sums_plain(vals)
    assert torch.equal(kp, pp) and torch.equal(kt, pt)


def _case_logistic_newton_terms_matches_plain(n, d):
    """The Newton-terms kernel (then ``chunk_sums``) against its plain
    version: rel 1e-6 of each output's largest magnitude (the kernel's
    ``expf`` against ``torch.exp``; everything else is pinned), and two
    runs bitwise equal."""
    import torch
    from repro_torch.kernels import logistic_grad as lg
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    X = rng.normal(0, 1, (n, d)).astype(np.float32)
    X[:, -1] = 1.0
    args = [_t(a, dev) for a in (
        X, (rng.random(n) < 0.3).astype(np.float32),
        (rng.random(n) < 0.9).astype(np.float32),
        rng.normal(0, 0.5, d).astype(np.float32))]
    before = lg.KERNEL.launches
    g, H = lg.logistic_newton_terms(*args)
    g2, H2 = lg.logistic_newton_terms(*args)
    assert lg.KERNEL.launches == before + 2
    assert torch.equal(g, g2) and torch.equal(H, H2)
    assert torch.equal(H, H.t())
    pg, pH = lg.logistic_newton_terms_plain(*args)
    for a, b in ((g, pg), (H, pH)):
        tol = 1e-6 * float(b.abs().max())
        assert float((a - b).abs().max()) <= tol, (n, d)
    with pytest.raises(ValueError, match="outside"):
        lg.logistic_newton_terms(torch.zeros((4, lg.MAX_D + 1), device=dev),
                                 args[1][:4], args[2][:4],
                                 torch.zeros((lg.MAX_D + 1,), device=dev))


def _newton_args(rng, n, d, dev):
    X = rng.normal(0, 1, (n, d)).astype(np.float32)
    X[:, -1] = 1.0
    return [_t(a, dev) for a in (
        X, (rng.random(n) < 0.3).astype(np.float32),
        (rng.random(n) < 0.9).astype(np.float32),
        rng.normal(0, 0.5, d).astype(np.float32))]


def _newton_close(g, H, pg, pH):
    for a, b in ((g, pg), (H, pH)):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    assert torch_equal(H, H.t())


def torch_equal(a, b):
    import torch
    return torch.equal(_bits(a), _bits(b))


# torch ops a one-launch wrapper may issue: an allocation and views of it,
# none of which runs anything on the card
NO_DEVICE_WORK = {"aten.empty", "aten.slice", "aten.select", "aten.view"}


def _torch_ops(fn):
    """The torch ops one call of ``fn`` dispatches (after a warm-up call)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    fn()
    with Ops() as mode:
        fn()
    return mode.ops


def _case_register_tree_kernels_one_launch_per_call():
    """``chunk_sums`` at the query's 10,240 x 5 and the standardisation's
    2^22 x 4, ``logistic_newton_terms`` at the reservoir's 8,192 x 4 and
    2^22 x 4: one ``Kernel.launch`` per call (its C entry launches one
    kernel) and no torch op that runs on the card, so one CUDA kernel per
    call (``chip_smoke.py`` counts the same with the profiler); bit for
    bit (Newton: rel 1e-6 of the plain version, two runs bitwise)."""
    import torch
    from repro_torch.kernels import logistic_grad as lg
    from repro_torch.kernels import segment_stats as ss
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    for n, s in ((10240, 5), (1 << 22, 4)):
        vals = _t(rng.normal(0, 100, (n, s)).astype(np.float32), dev)
        before = ss.CHUNK_SUMS.launches
        kp, kt = ss.chunk_sums(vals)
        assert ss.CHUNK_SUMS.launches == before + 1
        pp, pt = ss.chunk_sums_plain(vals)
        assert torch_equal(kp, pp) and torch_equal(kt, pt), (n, s)
        before = ss.CHUNK_SUMS.launches
        ops = _torch_ops(lambda: ss.chunk_sums(vals))
        assert ss.CHUNK_SUMS.launches == before + 2
        assert set(ops) <= NO_DEVICE_WORK, ops
    for n, d in ((8192, 4), (1 << 22, 4)):
        args = _newton_args(rng, n, d, dev)
        before = lg.KERNEL.launches
        g, H = lg.logistic_newton_terms(*args)
        assert lg.KERNEL.launches == before + 1
        g2, H2 = lg.logistic_newton_terms(*args)
        assert torch_equal(g, g2) and torch_equal(H, H2)
        _newton_close(g, H, *lg.logistic_newton_terms_plain(*args))
        before = lg.KERNEL.launches
        ops = _torch_ops(lambda: lg.logistic_newton_terms(*args))
        assert lg.KERNEL.launches == before + 2
        assert set(ops) <= NO_DEVICE_WORK, ops


def _case_ticket_returns_to_zero():
    """200 calls in a row alternating between one block and many (the
    ticket path) for each wrapper, each bit for bit its plain version
    (``chunk_sums``) or its first run (Newton): a counter left above 0
    would make no block the last. Then the same calls on a side stream,
    which holds a counter of its own."""
    import torch
    from repro_torch.kernels import logistic_grad as lg
    from repro_torch.kernels import segment_stats as ss
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    # 10,240 x 5: 50 (chunk, column) pairs, one block; 70,001 x 5: 345
    sums = []
    for n in (10240, 70001):
        vals = _t(rng.normal(0, 100, (n, 5)).astype(np.float32), dev)
        sums.append((vals, ss.chunk_sums_plain(vals)))
    # 3,000 rows: 3 tiles, one block; 70,001: 69 tiles, 18 blocks
    newton = []
    for n in (3000, 70001):
        args = _newton_args(rng, n, 4, dev)
        g, H = lg.logistic_newton_terms(*args)
        _newton_close(g, H, *lg.logistic_newton_terms_plain(*args))
        newton.append((args, g.clone(), H.clone()))

    def run(calls):
        for i in range(calls):
            vals, (pp, pt) = sums[i % 2]
            kp, kt = ss.chunk_sums(vals)
            assert torch_equal(kp, pp) and torch_equal(kt, pt), i
            args, g0, H0 = newton[i % 2]
            g, H = lg.logistic_newton_terms(*args)
            assert torch_equal(g, g0) and torch_equal(H, H0), i

    run(200)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(20)
    torch.cuda.current_stream().wait_stream(side)
    run(20)


def _case_register_tree_wrappers_refuse():
    """What the wrappers refuse (TypeError, ValueError) and what the C
    entry points refuse (cudaErrorInvalidValue: ``Kernel.launch`` raises
    and counts nothing): a chunk count or tile count that does not match
    N, and d above 64."""
    import torch
    from repro_torch.kernels import logistic_grad as lg
    from repro_torch.kernels import segment_stats as ss
    dev = torch.device("cuda")
    vals = torch.zeros((3000, 2), device=dev)
    with pytest.raises(TypeError):
        ss.chunk_sums(vals.double())
    with pytest.raises(ValueError, match="contiguous"):
        ss.chunk_sums(torch.zeros((2, 3000), device=dev).t())
    X, t, m, w = _newton_args(np.random.default_rng(10), 3000, 4, dev)
    with pytest.raises(ValueError, match="outside"):
        lg.logistic_newton_terms(torch.zeros((8, 65), device=dev), t[:8],
                                 m[:8], torch.zeros((65,), device=dev))
    with pytest.raises(ValueError):
        lg.logistic_newton_terms(X, t[:10], m, w)
    with pytest.raises(TypeError):
        lg.logistic_newton_terms(X, t, m.double(), w)
    with pytest.raises(ValueError):
        lg.logistic_newton_terms(X, t, m, w.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        lg.logistic_newton_terms(X.t().contiguous().t(), t, m, w)
    before = dict(ss.build.launch_counts())
    out = torch.empty((4, 2), device=dev)
    with pytest.raises(RuntimeError, match="failed to launch"):
        ss.CHUNK_SUMS.launch(dev, vals.data_ptr(), out.data_ptr(), 3000, 2,
                             2)
    scratch = torch.empty((1 << 16,), device=dev)
    with pytest.raises(RuntimeError, match="failed to launch"):
        lg.KERNEL.launch(dev, X.data_ptr(), t.data_ptr(), m.data_ptr(),
                         w.data_ptr(), scratch.data_ptr(), 3000, 4, 4)
    with pytest.raises(RuntimeError, match="failed to launch"):
        lg.KERNEL.launch(dev, X.data_ptr(), t.data_ptr(), m.data_ptr(),
                         w.data_ptr(), scratch.data_ptr(), 3000, 65, 3)
    assert ss.build.launch_counts() == before
    # and the counters still work
    pp, pt = ss.chunk_sums_plain(vals)
    kp, kt = ss.chunk_sums(vals)
    assert torch_equal(kp, pp) and torch_equal(kt, pt)


def _case_stream_step_reads_nothing_back():
    """A reservoir ingest and a retraction on the card under
    ``torch.cuda.set_sync_debug_mode("error")``: no op of the stream step
    waits for the device."""
    import torch
    from repro_torch.core.propensity import StreamStats
    rng = np.random.default_rng(6)
    names = ("a", "b", "c")
    cols = {c: _t(rng.normal(0, 1, 5000).astype(np.float32), "cuda")
            for c in names}
    valid = _t(rng.random(5000) > 0.1, "cuda")
    st = StreamStats.empty(names, capacity=1024, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = st.update(cols, valid)
        st = st.update(cols, valid, retract=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert st.n_batches == 2 and float(st.n) == 0.0


def _case_wrappers_refuse_what_the_kernels_do_not_take():
    import torch
    from repro_torch.kernels import segment_stats as ss
    dev = torch.device("cuda")
    x = torch.zeros((8, 3), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        ss.chunk_sums(x)
    y = torch.zeros((3, 8), device=dev).t()
    with pytest.raises(ValueError, match="contiguous"):
        ss.chunk_sums(y)
    with pytest.raises(ValueError):
        ss.scatter_merge(torch.zeros((4, 2), device=dev),
                         torch.zeros((2,), dtype=torch.int64),
                         torch.zeros((2, 2), device=dev))


def _case_engine_on_cuda_equals_engine_on_cpu():
    """A small stream (ingests with growth, a retraction, a re-ingest)
    through the engine on the card and on the CPU: the same snapshot
    (views and the streaming-propensity section) and the same estimates,
    bit for bit, the same propensity models within rel 1e-4, with every
    kernel launched."""
    from repro_torch.core import CoarsenSpec, OnlineEngine
    from repro_torch.data.columnar import Table
    from repro_torch.kernels import build
    rng = np.random.default_rng(4)
    specs = {"a": CoarsenSpec.categorical(8),
             "x": CoarsenSpec.equal_width(0, 1, 6),
             "z": CoarsenSpec.equal_width(-2, 2, 5)}
    treatments = {"t": ["a", "x"], "u": ["a", "z"]}

    def batch(n):
        cols = dict(a=rng.integers(0, 8, n).astype(np.int32),
                    x=rng.random(n).astype(np.float32),
                    z=rng.normal(0, 1, n).astype(np.float32),
                    t=rng.integers(0, 2, n).astype(np.int32),
                    u=rng.integers(0, 2, n).astype(np.int32),
                    y=rng.normal(10, 3, n).astype(np.float32))
        return cols, rng.random(n) > 0.1

    batches = [batch(4000) for _ in range(3)]
    engines = [OnlineEngine(specs, treatments, outcome="y",
                            query_dims=("a",), granule=64,
                            reservoir_size=2048, device=dev)
               for dev in ("cuda", "cpu")]
    build.reset_launches()
    for eng in engines:
        for cols, valid in (*batches, batches[0]):
            eng.ingest(Table.from_numpy(cols, valid, device=eng.device))
        eng.refresh_propensity("t", ["x", "z"])
        eng.ingest(Table.from_numpy(*batches[1], device=eng.device),
                   retract=True)
        eng.refresh_propensity("t", ["x", "z"])
    sg, sc = (e.export_canonical() for e in engines)
    for k in ("pri", "n", "n_batches"):
        np.testing.assert_array_equal(sg["stream"][k], sc["stream"][k])
    for part in ("res", "sums", "sumsqs"):
        for c, col in sc["stream"][part].items():
            np.testing.assert_array_equal(
                sg["stream"][part][c].view(np.uint32), col.view(np.uint32))
    mg, mc = (e.models["t"] for e in engines)
    for f in ("w", "mean", "std"):
        a, b = getattr(mg, f).cpu().numpy(), getattr(mc, f).numpy()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert bool(mg.converged) == bool(mc.converged)
    for name, vc in sc["views"].items():
        vg = sg["views"][name]
        for k in ("hi", "lo", "touch", "keep"):
            if k in vc:
                np.testing.assert_array_equal(vg[k], vc[k])
        for k, col in vc["stats"].items():
            np.testing.assert_array_equal(vg["stats"][k].view(np.uint32),
                                          col.view(np.uint32))
    for t in treatments:
        for sub in (None, {"a": [0, 3]}):
            eg, ec = (e.ate(t, sub) for e in engines)
            for f in ("ate", "att", "variance", "n_groups",
                      "n_matched_treated", "n_matched_control"):
                assert getattr(eg, f) == getattr(ec, f), (t, sub, f)
    # every kernel of the replicated path (the partitioned merge and the
    # matching kernels are not among them)
    assert all(v > 0 for k, v in build.launch_counts().items()
               if k not in ("scatter_merge_parts", "knn_topk",
                            "greedy_sweep"))


def _case_scatter_merge_parts_matches_plain(n_parts, b):
    """The partitioned merge against its plain version, bitwise: positions
    sorted within each partition with a long duplicate run at each
    partition's end (the padding rows), equal positions on both sides of
    the first partition boundary (b = 300: inside a 256-row tile),
    out-of-range positions before a middle partition's start and past
    another's end, an empty partition (every position past the end); one
    launch, and none for the empty delta."""
    import torch
    from repro_torch.kernels import segment_stats as ss
    dev = torch.device("cuda")
    rng = np.random.default_rng(n_parts * 1000 + b)
    c, s = 4000, 12
    q, r = b // 4, b // 3

    def part(p):
        if p == 3:                                 # an empty partition
            return np.full(b, c)
        x = np.sort(rng.integers(0 if p == 2 else 100, c, b))
        x[-r:] = c - 1                             # the padding rows' run
        if n_parts == 1:
            return x
        if p == 0:                                 # ends at slot 100 ...
            x = np.sort(rng.integers(0, 100, b))
            x[-r:] = 100
        if p == 1:                                 # ... where p=1 starts
            x[:q] = 100
            x[-9:] = c + 3                         # past the end: dropped
        if p == 2:
            x[:7] = -5                             # before the start
        return x

    pos = np.stack([part(p) for p in range(n_parts)])
    tables = _t(rng.normal(0, 5, (n_parts, c, s)).astype(np.float32), dev)
    vals = _t(rng.normal(0, 1, (n_parts, b, s)).astype(np.float32), dev)
    pos = _t(pos.astype(np.int64), dev)
    before = ss.SCATTER_MERGE_PARTS.launches
    got = ss.scatter_merge_parts(tables.clone(), pos, vals)
    assert ss.SCATTER_MERGE_PARTS.launches == before + 1
    want = ss.scatter_merge_parts_plain(tables.clone(), pos, vals)
    assert torch.equal(_bits(got), _bits(want))
    for p in range(n_parts):               # = the single-table merge
        assert torch.equal(_bits(got[p]), _bits(ss.scatter_merge(
            tables[p].clone(), pos[p].contiguous(), vals[p].contiguous())))
    out = ss.scatter_merge_parts(tables.clone(), pos[:, :0].contiguous(),
                                 vals[:, :0].contiguous())
    assert torch.equal(_bits(out), _bits(tables))
    assert ss.SCATTER_MERGE_PARTS.launches == before + 1
    with pytest.raises(ValueError):
        ss.scatter_merge_parts(tables, pos[0], vals)


def _case_partitioned_engine_on_cuda_equals_engine_on_cpu():
    """A small partitioned stream (ingests with growth, a retraction, a
    re-ingest, ``ate()`` and ``matched_rows``) on the card and on the CPU:
    the same snapshot and estimates and masks, bit for bit, with the
    partitioned merge launched. The retraction and ``matched_rows`` run
    under ``torch.cuda.set_sync_debug_mode("error")``: nothing waits for
    the device but the engine's counted host reads."""
    import torch
    from repro_torch.core import CoarsenSpec, PartitionedOnlineEngine
    from repro_torch.data.columnar import Table
    from repro_torch.kernels import build
    rng = np.random.default_rng(8)
    specs = {"a": CoarsenSpec.categorical(16),
             "x": CoarsenSpec.equal_width(0, 1, 8),
             "z": CoarsenSpec.equal_width(-2, 2, 6)}
    treatments = {"t": ["a", "x"], "u": ["a", "z"]}

    def batch(n, a_hi):
        cols = dict(a=rng.integers(0, a_hi, n).astype(np.int32),
                    x=rng.random(n).astype(np.float32),
                    z=rng.normal(0, 1, n).astype(np.float32),
                    t=rng.integers(0, 2, n).astype(np.int32),
                    u=rng.integers(0, 2, n).astype(np.int32),
                    y=rng.normal(10, 3, n).astype(np.float32))
        return cols, rng.random(n) > 0.1

    batches = [batch(3000, 4), batch(3000, 16), batch(3000, 16)]
    probe = batch(5000, 16)
    engines = [PartitionedOnlineEngine(specs, treatments, outcome="y",
                                       n_parts=3, query_dims=("a",),
                                       granule=128, reservoir_size=1024,
                                       device=dev)
               for dev in ("cuda", "cpu")]
    build.reset_launches()
    masks, fast = [], []
    for eng in engines:
        fetch = eng._fetch

        def counted_read(tensors, fetch=fetch):
            torch.cuda.set_sync_debug_mode("default")
            try:
                return fetch(tensors)
            finally:
                torch.cuda.set_sync_debug_mode("error")

        reports = [eng.ingest(Table.from_numpy(cols, valid,
                                               device=eng.device))
                   for cols, valid in batches]
        for t in treatments:
            eng.ate(t)
        retract = Table.from_numpy(*batches[1], device=eng.device)
        table = Table.from_numpy(*probe, device=eng.device)
        torch.cuda.synchronize()
        eng._fetch = counted_read
        torch.cuda.set_sync_debug_mode("error")
        try:
            rep = eng.ingest(retract, retract=True)
            masks.append([eng.matched_rows(t, table) for t in treatments])
        finally:
            torch.cuda.set_sync_debug_mode("default")
            eng._fetch = fetch
        assert all(rep.fast_path.values())
        reports += [rep, eng.ingest(retract)]
        fast.append(sum(sum(r.fast_path.values()) for r in reports))
    # one launch per fast-path view merge on the card, none on the CPU
    assert build.launch_counts()["scatter_merge_parts"] == fast[0] >= 6
    assert fast[0] == fast[1]
    assert build.launch_counts()["scatter_merge"] == 0
    for mg, mc in zip(*masks):
        assert torch.equal(mg.cpu(), mc)
    sg, sc = (e.export_canonical() for e in engines)
    for name, vc in sc["views"].items():
        vg = sg["views"][name]
        for k in ("hi", "lo", "touch", "keep"):
            if k in vc:
                np.testing.assert_array_equal(vg[k], vc[k])
        for k, col in vc["stats"].items():
            np.testing.assert_array_equal(vg["stats"][k].view(np.uint32),
                                          col.view(np.uint32))
    np.testing.assert_array_equal(sg["stream"]["pri"], sc["stream"]["pri"])
    assert engines[0].stats() == engines[1].stats()
    for t in treatments:
        for sub in (None, {"a": [0, 3]}):
            eg, ec = (e.ate(t, sub) for e in engines)
            for f in ("ate", "att", "variance", "n_groups",
                      "n_matched_treated", "n_matched_control"):
                assert getattr(eg, f) == getattr(ec, f), (t, sub, f)


def test_kernels_and_engine_on_the_card_match_plain(cuda):
    """Every kernel against its plain version on the card, the wrappers'
    guards, and the engine on the card against the engine on the CPU."""
    _case_cem_keys_matches_plain()
    for n_groups, invalid in ((5000, 0.3), (3, 0.9)):
        _case_segment_sums_matches_plain(n_groups, invalid)
    _case_segment_sums_matches_plain(40, 0.5, s=6)
    for s in (1, 6, 12):
        _case_segment_sums_run_lengths(s)
        _case_scatter_merge_run_lengths(s)
    for s in (6, 12):
        _case_segment_sums_run_lengths(s, unaligned=True)
        _case_scatter_merge_run_lengths(s, unaligned=True)
    _case_segment_sums_run_lengths(4, lengths=(1 << 20,))
    _case_scatter_merge_matches_plain()
    _case_tree_kernels_device_ops_and_empty_inputs()
    for n in (1, 1024, 70001):
        _case_chunk_sums_matches_plain(n)
    for n, d in ((8192, 4), (70001, 9), (5, 1), (3000, 64)):
        _case_logistic_newton_terms_matches_plain(n, d)
    _case_stream_step_reads_nothing_back()
    _case_wrappers_refuse_what_the_kernels_do_not_take()
    _case_engine_on_cuda_equals_engine_on_cpu()


def test_register_tree_kernels_on_the_card(cuda):
    """``chunk_sums`` and ``logistic_newton_terms``: one launch and one
    device op per call at the main path's shapes and at 2^22 rows, the
    ticket back at 0 after every call (200 alternating calls, two
    streams), and the wrappers' and C entry points' refusals."""
    _case_register_tree_kernels_one_launch_per_call()
    _case_ticket_returns_to_zero()
    _case_register_tree_wrappers_refuse()


def test_cem_keys_column_route_on_the_card(cuda):
    """``cem_keys``: the column route bitwise its plain version over every
    dtype and stride case, one device op a call, the launch on PyTorch's
    current stream; and the ticketed ``chunk_sums`` and Newton kernels
    putting their counters back to 0 after the lighter ``Kernel.launch``
    (200 alternating calls, two streams)."""
    _case_cem_keys_column_route()
    _case_ticket_returns_to_zero()


def test_partitioned_merge_and_engine_on_the_card_match_plain(cuda):
    """The partitioned merge kernel against its plain version, and the
    partitioned engine on the card against the engine on the CPU."""
    for n_parts, b in ((1, 300), (3, 300), (4, 300), (4, 5000)):
        _case_scatter_merge_parts_matches_plain(n_parts, b)
    _case_partitioned_engine_on_cuda_equals_engine_on_cpu()


def _case_knn_topk_matches_plain(nq, nc, d, k, share, integer):
    """The k-NN kernel against its plain version: ragged query blocks and
    control tiles, k = 1 / 8 / 16 and widths on both register paths,
    exact ties (integer features), all controls invalid and fewer valid
    controls than k — (d2, idx) bit for bit, one launch."""
    import torch
    from repro_torch.kernels import knn_topk as tk
    dev = torch.device("cuda")
    rng = np.random.default_rng(nq * 7 + nc + d + k)
    if integer:
        Q = rng.integers(-3, 4, (nq, d)).astype(np.float32)
        C = rng.integers(-3, 4, (nc, d)).astype(np.float32)
    else:
        Q = rng.normal(0, 2, (nq, d)).astype(np.float32)
        C = rng.normal(0, 2, (nc, d)).astype(np.float32)
    Q, C = _t(Q, dev), _t(C, dev)
    v = _t(rng.random(nc) < share, dev)
    before = tk.KERNEL.launches
    kd, ki = tk.knn_topk(Q, C, v, k)
    assert tk.KERNEL.launches == before + 1
    pd, pi = tk.knn_topk_plain(Q, C, v, k)
    assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))
    assert torch.equal(ki, pi)
    n_valid = int(v.sum())
    if n_valid < k:
        assert bool((ki[:, n_valid:] == -1).all())


def _case_greedy_sweep_matches_plain(n_edges, n_rows, k, quantum,
                                     big=0.2, unsorted=False, n_ids=None):
    """The sweep kernels against their plain version: edges sorted (or,
    with ``unsorted``, in random order with NaN and inf distances), a
    ``big`` share at BIG, out-of-range indices (clipped), with
    ``quantum`` equal distances, with ``n_ids`` few distinct indices (many
    edges for each control and unit); the state in shared memory or, for n_rows above
    what fits or k above 255, in device memory — the taken flags equal,
    one launch."""
    import torch
    from repro_torch.kernels import greedy_sweep as gs
    dev = torch.device("cuda")
    rng = np.random.default_rng(n_edges + k)
    d = rng.random(n_edges).astype(np.float32)
    if quantum:
        d = (np.round(d / quantum) * quantum).astype(np.float32)
    d[rng.random(n_edges) < big] = np.float32(3.4e38)
    if unsorted:
        d[rng.random(n_edges) < 0.05] = np.nan
        d[rng.random(n_edges) < 0.05] = np.inf
    else:
        d = np.sort(d, kind="stable")
    hi = n_ids or n_rows
    c = rng.integers(-2, hi + 2, n_edges).astype(np.int64)
    t = rng.integers(0, hi, n_edges).astype(np.int64)
    args = (_t(d, dev), _t(c, dev), _t(t, dev), n_rows, k)
    before = gs.KERNEL.launches
    got = gs.greedy_sweep(*args)
    assert gs.KERNEL.launches == before + 1
    assert torch.equal(got, gs.greedy_sweep_plain(*args))


def _case_matching_wrappers_refuse():
    import torch
    from repro_torch.kernels import knn_topk as tk
    dev = torch.device("cuda")
    Q = torch.zeros((4, 3), device=dev)
    v = torch.ones((4,), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="limit"):
        tk.knn_topk(Q, Q, v, tk.MAX_K + 1)
    with pytest.raises(ValueError):
        tk.knn_topk(Q, Q, v.cpu(), 2)
    with pytest.raises(TypeError):
        tk.knn_topk(Q, Q, v.to(torch.int32), 2)


def test_matching_kernels_on_the_card_match_plain(cuda):
    """The k-NN and sweep kernels against their plain versions, and the
    wrappers' guards."""
    # S = 1 (fewer than 2,048 controls, or enough query blocks) and S > 1
    # (few query blocks); K = 1, 8, 16; exact widths 1-8 and the padded 64;
    # query counts off every multiple of R x 128
    for case in ((300, 1000, 5, 1, 0.5, False), (129, 4099, 5, 8, 0.3, True),
                 (1000, 777, 3, 16, 0.7, True), (64, 300, 64, 8, 0.5, False),
                 (257, 513, 9, 5, 0.0, False), (200, 300, 2, 16, 0.02, True),
                 (8191, 1 << 15, 5, 8, 0.9, False),
                 (5000, 3000, 1, 1, 0.5, True),
                 (777, 2500, 7, 16, 0.5, True), (1100, 2100, 8, 8, 0.4, False),
                 (33, 5000, 64, 16, 0.5, False), (70001, 700, 6, 3, 0.5, True),
                 (600000, 2100, 4, 1, 0.5, True)):
        _case_knn_topk_matches_plain(*case)
    # state in shared memory; in device memory (n_rows above ~177,000, or
    # k above 255); every edge below BIG (2^20 of them); none; unsorted
    # with NaN and inf; few distinct controls and units
    for case in ((50000, 3000, 1, 0.0), (20000, 500, 2, 0.01),
                 (1, 1, 1, 0.0)):
        _case_greedy_sweep_matches_plain(*case)
    _case_greedy_sweep_matches_plain(1 << 20, 1 << 17, 1, 0.0, big=0.0)
    _case_greedy_sweep_matches_plain(300000, 300000, 1, 0.0)
    _case_greedy_sweep_matches_plain(50000, 3000, 300, 0.0, n_ids=200)
    _case_greedy_sweep_matches_plain(20000, 5000, 1, 0.0, big=1.0)
    _case_greedy_sweep_matches_plain(60000, 5000, 2, 0.0, unsorted=True)
    _case_greedy_sweep_matches_plain(40000, 1000, 3, 0.0, n_ids=40)
    _case_matching_wrappers_refuse()
