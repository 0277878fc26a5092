"""The key-range partitioned layout of the port
(``repro_torch.core.PartitionedOnlineEngine``, routed deltas,
``matched_rows``, ``cem_groups`` and the scatter-merge-parts kernel's plain
version) against the reference on the CPU: the same numpy inputs, made
from seeds, go through ``repro`` (JAX on the CPU; its Pallas kernel in
interpret mode) and ``repro_torch`` (``device="cpu"``: the kernels' plain
versions).

The stream: batches drawn from a seed with integer-valued outcomes (so
f32 sums are exact in any order), the first two over a third of the
``x0`` range and the later ones over all of it, so every layout re-sorts
and grows; then an exact retraction, a re-ingest and a retraction of rows
never ingested, which both packages must refuse with state untouched.
Queries after every step, whole and on a sub-population. The delta
granule (1024) holds every delta of the stream, so the reference never
takes its delta-overflow fallback, whose capacity rule the port does not
have (ROADMAP Queue 3): capacities can then be compared too.

Tolerances, those of ``tests/test_torch_online.py``:

- keys, group validity, overlap keep, touch stamps, count columns,
  ``n_groups``, matched counts and masks, ``DeltaReport`` fields,
  capacities: exact; the reservoir and its priorities: bitwise.
- outcome sums: |diff| <= 1e-5 times the column's largest magnitude (here
  they are integer-valued, so both packages get them exactly);
  ``ate``/``att`` rtol 1e-4, ``variance`` rtol 1e-3 (XLA reduces in
  another order than the port's pinned chunked sums).
- within the port, partitioned against replicated: bitwise, every
  snapshot field and every estimate.

Few test items on purpose: see ``tests/test_torch_kernels.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from repro.core import CoarsenSpec as JSpec
from repro.core import OnlineEngine as JEngine
from repro.core import PartitionedOnlineEngine as JPartEngine
from repro.core import cube as jcube
from repro.data.columnar import Table as JTable
from repro.kernels import ref as jref
from repro.kernels.ops import scatter_merge_parts_op as j_parts_op

from test_torch_online import _assert_snapshots, _close
from test_torch_propensity import _assert_stream_sections, _bits

TREATMENTS = {"ta": ["x0", "x1"], "tb": ["x0", "x2"]}
CARDS = {"x0": 12, "x1": 10, "x2": 8}
SUBPOPS = (None, {"x0": [1, 2]})
ENGINE_KW = dict(query_dims=("x0",), granule=256, delta_granule=1024,
                 reservoir_size=256)
EST_FIELDS = ("ate", "att", "n_matched_treated", "n_matched_control",
              "n_groups", "variance")


def _specs(S):
    return {k: S.categorical(c) for k, c in CARDS.items()}


def _frame(n, seed, x0_hi=12):
    """One batch (``tests/test_online_partitioned.py:19-58``, wider
    dims): integer outcomes, ~8 % invalid rows."""
    rng = np.random.default_rng(seed)
    cols = {k: rng.integers(0, x0_hi if k == "x0" else c, n).astype(np.int32)
            for k, c in CARDS.items()}
    p = 0.1 + 0.8 * cols["x0"] / 11
    cols["ta"] = (rng.random(n) < p).astype(np.int32)
    cols["tb"] = (rng.random(n) < 0.4).astype(np.int32)
    y = 2.0 * cols["ta"] + 1.5 * cols["x0"] + rng.normal(0, 3, n)
    cols["y"] = np.round(y).astype(np.float32)
    return cols, rng.random(n) > 0.08


def _stream():
    """(steps, probe): ingests that add keys (x0 < 4, then all of x0), an
    exact retraction, a re-ingest, a refused retraction of rows never
    ingested; the probe of ``matched_rows`` is the full table, every
    batch of the stream."""
    b = [_frame(1000, seed=10 + i, x0_hi=4 if i < 2 else 12)
         for i in range(5)]
    never = _frame(300, seed=99)
    steps = [("ingest", b[0]), ("ingest", b[1]), ("ingest", b[2]),
             ("ingest", b[3]), ("retract", b[2]), ("ingest", b[2]),
             ("retract", never), ("ingest", b[4])]
    parts = [*b, never]
    probe = ({k: np.concatenate([c[k] for c, _ in parts]) for k in b[0][0]},
             np.concatenate([v for _, v in parts]))
    return steps, probe


def _t(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------- one step, any engine
def _record(eng, make_table, step):
    """Play one step; return the DeltaReport fields (or the refusal), the
    estimates, ``stats()`` and the snapshot."""
    op, batch = step
    try:
        rep = eng.ingest(make_table(*batch), retract=op == "retract")
        out = dict(n_rows=rep.n_rows, n_delta_groups=int(rep.n_delta_groups),
                   fast_path=dict(rep.fast_path))
    except ValueError as e:
        out = dict(error=type(e).__name__)
    out["est"] = {(t, repr(s)): {f: float(getattr(eng.ate(t, s), f))
                                 for f in EST_FIELDS}
                  for t in sorted(TREATMENTS) for s in SUBPOPS}
    out["stats"] = eng.stats()
    out["snap"] = eng.export_canonical()
    return out


def _port_engine(n_parts=None, **kw):
    from repro_torch.core import CoarsenSpec, OnlineEngine, \
        PartitionedOnlineEngine
    if n_parts is None:
        return OnlineEngine(_specs(CoarsenSpec), TREATMENTS, outcome="y",
                            device="cpu", **ENGINE_KW, **kw)
    return PartitionedOnlineEngine(_specs(CoarsenSpec), TREATMENTS,
                                   outcome="y", n_parts=n_parts,
                                   device="cpu", **ENGINE_KW, **kw)


def _port_table(cols, valid):
    from repro_torch.data.columnar import Table
    return Table.from_numpy(cols, valid, device="cpu")


def _ref_engine(n_parts=None, **kw):
    if n_parts is None:
        return JEngine(_specs(JSpec), TREATMENTS, outcome="y", **ENGINE_KW,
                       **kw)
    return JPartEngine(_specs(JSpec), TREATMENTS, outcome="y",
                       n_parts=n_parts, **ENGINE_KW, **kw)


def _row_queries(eng, probe, port):
    """matched_rows of every treatment over ``probe`` (host bool masks) and
    the content of cem_groups: the valid groups, key-sorted."""
    table = _port_table(*probe) if port else JTable.from_numpy(*probe)
    out = {}
    for t in sorted(TREATMENTS):
        m = np.asarray(eng.matched_rows(t, table))
        g = eng.cem_groups(t)
        host = {k: np.asarray(v) for k, v in dict(
            hi=g.grouping.group_hi, lo=g.grouping.group_lo,
            gv=g.grouping.group_valid, keep=g.keep, nt=g.n_treated,
            nc=g.n_control, yt=g.sum_y_t, yc=g.sum_y_c).items()}
        gv = host.pop("gv").astype(bool)
        host = {k: v[gv] for k, v in host.items()}
        order = np.lexsort((host["lo"].astype(np.int64),
                            host["hi"].astype(np.int64)))
        out[t] = dict(matched=m.astype(bool),
                      groups={k: v[order] for k, v in host.items()})
    return out


# ------------------------------------------------------------------ compare
def _assert_estimates(et, ej, exact):
    for key, vj in ej.items():
        vt = et[key]
        for f in ("n_groups", "n_matched_treated", "n_matched_control"):
            assert vt[f] == vj[f], (key, f)
        if exact:
            assert vt == vj, key
            continue
        _close(vt["ate"], vj["ate"], 1.0, 1e-4)
        _close(vt["att"], vj["att"], 1.0, 1e-4)
        _close(vt["variance"], vj["variance"], 1e-3, 1e-3)


def _assert_bitwise(a, b, path="snap"):
    """Two snapshots (nested dicts of arrays and scalars) bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_bitwise(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8),
                                      err_msg=path)
    else:
        assert a == b, path


def _assert_row_queries(rt, rj):
    for t, qj in rj.items():
        qt = rt[t]
        np.testing.assert_array_equal(qt["matched"], qj["matched"],
                                      err_msg=t)
        assert 0 < qj["matched"].sum() < qj["matched"].size
        for k, vj in qj["groups"].items():
            vt = qt["groups"][k]
            if k in ("hi", "lo"):
                vt, vj = vt.astype(np.int64), vj.astype(np.int64)
            np.testing.assert_array_equal(vt, vj, err_msg=f"{t}.{k}")


# ------------------------------------------------------------- the helpers
def _check_partition_ids_match_reference():
    from repro_torch.core import cube
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    hi[:3], lo[:3] = 0xFFFFFFFF, 0xFFFFFFFF       # the invalid marker
    hi[3:6], lo[3:6] = 0, (0, 1, 0xFFFFFFFF)
    for n_parts in (1, 2, 3, 4, 7, 8, 1000):
        got = cube.partition_ids(_t(hi.astype(np.int64)),
                                 _t(lo.astype(np.int64)), n_parts).numpy()
        want = np.asarray(jcube.partition_ids(hi, lo, n_parts))
        np.testing.assert_array_equal(got, want.astype(np.int64))
        assert got.min() >= 0 and got.max() < n_parts
    with pytest.raises(ValueError):
        cube.partition_ids(_t(hi.astype(np.int64)), _t(lo.astype(np.int64)),
                           1 << 16)


def _check_route_delta_matches_reference():
    """A rolled-up delta (valid groups, then invalid rows) routed: each
    partition's valid rows and stats exactly the reference's, in the same
    key order, marker-padded."""
    from repro_torch.core import cube
    rng = np.random.default_rng(4)
    keys = np.unique(rng.integers(0, 2**40, 300, dtype=np.uint64))
    n, s = keys.shape[0], 4
    hi = np.concatenate([(keys >> 32).astype(np.uint32),
                         np.full(40, 0xFFFFFFFF, np.uint32)])
    lo = np.concatenate([(keys & 0xFFFFFFFF).astype(np.uint32),
                         np.full(40, 0xFFFFFFFF, np.uint32)])
    gv = np.arange(n + 40) < n
    stats = np.where(gv[:, None], rng.integers(-5, 6, (n + 40, s)),
                     0).astype(np.float32)
    names = [f"c{j}" for j in range(s)]
    for n_parts in (1, 3, 4):
        got = cube.route_delta(_t(hi.astype(np.int64)),
                               _t(lo.astype(np.int64)), _t(stats), _t(gv),
                               n_parts)
        want = jcube.route_delta(jnp.asarray(hi), jnp.asarray(lo),
                                 {k: jnp.asarray(stats[:, j])
                                  for j, k in enumerate(names)},
                                 jnp.asarray(gv), n_parts)
        for p in range(n_parts):
            wgv = np.asarray(want[3][p])
            k = int(wgv.sum())
            tgv = got[3][p].numpy()
            assert tgv[:k].all() and not tgv[k:].any()
            for a, b in ((got[0], want[0]), (got[1], want[1])):
                np.testing.assert_array_equal(
                    a[p].numpy()[:k], np.asarray(b[p])[:k].astype(np.int64))
                assert (a[p].numpy()[k:] == 0xFFFFFFFF).all()
            np.testing.assert_array_equal(
                got[2][p].numpy()[:k],
                np.stack([np.asarray(want[2][c][p])[:k] for c in names], 1))
            assert not got[2][p].numpy()[k:].any()


def _port_scatter_merge_parts_plain(tables, pos, vals):
    from repro_torch.kernels import segment_stats as ss
    return ss.scatter_merge_parts_plain(_t(tables.copy()), _t(pos),
                                        _t(vals)).numpy()


def _check_scatter_merge_parts_plain_matches_reference():
    """The inputs of ``tests/test_online_fused.py:300-318``: random unsorted
    positions (duplicates included), and the empty delta; rtol 1e-6 of
    the Pallas kernel in interpret mode and of per-partition
    ``scatter_merge_ref``."""
    rng = np.random.default_rng(9)
    p, c, s, b = 3, 256, 5, 130
    tables = rng.normal(0, 1, (p, c, s)).astype(np.float32)
    pos = rng.integers(0, c, (p, b)).astype(np.int32)
    vals = rng.normal(0, 1, (p, b, s)).astype(np.float32)
    got = _port_scatter_merge_parts_plain(tables, pos.astype(np.int64), vals)
    pallas = np.asarray(j_parts_op(jnp.asarray(tables), jnp.asarray(pos),
                                   jnp.asarray(vals), block=64))
    oracle = np.stack([np.asarray(jref.scatter_merge_ref(
        jnp.asarray(tables[i]), jnp.asarray(pos[i]), jnp.asarray(vals[i])))
        for i in range(p)])
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    out = _port_scatter_merge_parts_plain(
        tables, np.zeros((p, 0), np.int64), np.zeros((p, 0, s), np.float32))
    np.testing.assert_array_equal(out, tables)


def _check_scatter_merge_parts_plain_is_per_partition_merge():
    """Bitwise per-partition ``scatter_merge_plain`` on the fast path's
    kind of input: positions sorted within each partition, a long
    duplicate run at each partition's end (the padding rows), equal
    positions on both sides of a partition boundary inside one 256-row
    tile, out-of-range positions at both ends of a middle partition, and
    an empty partition (every position out of range)."""
    from repro_torch.kernels import segment_stats as ss
    rng = np.random.default_rng(11)
    p, c, b, s = 4, 300, 700, 6        # boundaries at rows 700, 1400, 2100

    def run(lo, hi, n):
        return np.sort(rng.integers(lo, hi, n))

    pos = np.stack([
        np.concatenate([run(0, 10, b - 300), np.full(300, 10)]),
        np.concatenate([np.full(5, 10), run(10, c, b - 305),
                        np.full(300, c - 1)]),
        np.concatenate([np.full(7, -3), run(0, c, b - 316),
                        np.full(300, c - 1), np.full(9, c + 2)]),
        np.full(b, c)]).astype(np.int64)
    tables = rng.normal(0, 5, (p, c, s)).astype(np.float32)
    vals = rng.normal(0, 1, (p, b, s)).astype(np.float32)
    got = _port_scatter_merge_parts_plain(tables, pos, vals)
    for i in range(p):
        want = ss.scatter_merge_plain(_t(tables[i].copy()), _t(pos[i]),
                                      _t(vals[i])).numpy()
        np.testing.assert_array_equal(_bits(got[i]), _bits(want))
    np.testing.assert_array_equal(got[3], tables[3])
    slots = ss._part_slots(_t(pos), c).numpy().reshape(p, b)
    assert (slots[2, :7] == -1).all() and (slots[2, -9:] == -1).all()
    assert slots[0, -1] == 10 and slots[1, 0] == c + 10


# -------------------------------------------------------------- the stream
def _check_stream_matches_reference_and_replicated():
    steps, probe = _stream()
    port_rep = _port_engine()
    rep_records = [_record(port_rep, _port_table, st) for st in steps]
    rep_rows = _row_queries(port_rep, probe, port=True)
    refused = [("error" in r) for r in rep_records]
    assert refused == [False] * 6 + [True, False]
    # re-sorts and growth happened; the retraction and re-ingest are fast
    assert not any(rep_records[2]["fast_path"].values())
    assert all(rep_records[4]["fast_path"].values())
    assert rep_records[-1]["stats"]["__base__"]["capacity"] > 256
    for n_parts in (1, 2, 3):
        port = _port_engine(n_parts)
        ref = _ref_engine(n_parts, use_pallas=n_parts == 2)
        jax.clear_caches()
        for i, st in enumerate(steps):
            rt = _record(port, _port_table, st)
            rj = _record(ref, JTable.from_numpy, st)
            for k in ("n_rows", "n_delta_groups", "fast_path", "error"):
                assert rt.get(k) == rj.get(k), (n_parts, i, k)
            assert rt["stats"] == rj["stats"], (n_parts, i)
            _assert_snapshots(rt["snap"], rj["snap"])
            _assert_stream_sections(rt["snap"]["stream"],
                                    rj["snap"]["stream"])
            _assert_estimates(rt["est"], rj["est"], exact=False)
            # partitioned == replicated, bit for bit
            _assert_bitwise(rt["snap"], rep_records[i]["snap"])
            if "error" in rt:                  # refused: state untouched
                _assert_bitwise(rt["snap"], before)
            before = rt["snap"]
            _assert_estimates(rt["est"], rep_records[i]["est"], exact=True)
            for name, entry in rt["stats"].items():
                assert entry["n_parts"] == n_parts
                assert entry["n_groups"] == \
                    rep_records[i]["stats"][name]["n_groups"]
        rows = _row_queries(port, probe, port=True)
        _assert_row_queries(rows, _row_queries(ref, probe, port=False))
        _assert_row_queries(rows, rep_rows)
    _assert_row_queries(rep_rows, _row_queries(
        _stream_ref_replicated(steps), probe, port=False))


def _stream_ref_replicated(steps):
    ref = _ref_engine()
    for op, batch in steps:
        try:
            ref.ingest(JTable.from_numpy(*batch), retract=op == "retract")
        except ValueError:
            pass
    return ref


# ----------------------------------------------------- snapshots, contracts
def _check_reference_snapshots_install_into_partitioned():
    """A reference replicated and a reference partitioned snapshot install
    into the port's ``PartitionedOnlineEngine(n_parts=3)``; further ingests
    answer as the reference engine that never stopped."""
    steps, _ = _stream()
    for source in (None, 2):
        ref = _ref_engine(source)
        for op, batch in steps[:3]:
            ref.ingest(JTable.from_numpy(*batch), retract=op == "retract")
        for t in sorted(TREATMENTS):
            ref.ate(t, SUBPOPS[1])
        port = _port_engine(3)
        port.install_canonical(ref.export_canonical())
        _assert_snapshots(port.export_canonical(), ref.export_canonical())
        assert port.cached_estimate("ta", SUBPOPS[1]) is not None
        for st in steps[3:6]:
            rt = _record(port, _port_table, st)
            rj = _record(ref, JTable.from_numpy, st)
            assert rt["fast_path"] == rj["fast_path"]
            _assert_snapshots(rt["snap"], rj["snap"])
            _assert_stream_sections(rt["snap"]["stream"],
                                    rj["snap"]["stream"])
            _assert_estimates(rt["est"], rj["est"], exact=False)
        jax.clear_caches()


def _check_engine_contracts():
    """Positions of every partitioned fast-path merge non-decreasing within
    each partition (the kernel's precondition), with a duplicate run; the
    replicated engine's host reads; unported options and bad ``n_parts``
    refused."""
    from repro_torch.core import fused as fused_mod
    steps, _ = _stream()
    seen = []
    merge_fast = fused_mod.merge_fast

    def checked(tname, treatments, st, pos, *args, **kw):
        p = pos.numpy()
        assert p.ndim == 2 and (np.diff(p, axis=1) >= 0).all()
        seen.append(int((np.diff(p, axis=1) == 0).sum()))
        return merge_fast(tname, treatments, st, pos, *args, **kw)

    def play(eng):
        for op, batch in steps:
            try:
                eng.ingest(_port_table(*batch), retract=op == "retract")
            except ValueError:
                pass
        return eng.host_reads

    reads = [play(_port_engine())]
    fused_mod.merge_fast = checked
    try:
        reads.append(play(_port_engine(3)))
    finally:
        fused_mod.merge_fast = merge_fast
    assert reads[0] == reads[1]
    assert len(seen) >= 12 and max(seen) > 0
    for kw in (dict(mesh=object()), dict(overlap=True),
               dict(keep_rows=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _port_engine(2, **kw)
    for bad in (0, 1 << 16):
        with pytest.raises(ValueError, match="n_parts"):
            _port_engine(bad)


@pytest.fixture(autouse=True)
def _release_compiled_programs():
    """Drop the worker's compiled XLA programs before and after each test
    (see the module docstring of ``tests/test_torch_kernels.py``)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


# ----------------------------------------------------------------- the tests
def test_partition_helpers_and_merge_kernel_plain_version():
    """``partition_ids`` bitwise, ``route_delta`` exactly, and the
    scatter-merge-parts kernel's plain version against the reference and
    against per-partition ``scatter_merge_plain``."""
    _check_partition_ids_match_reference()
    _check_route_delta_matches_reference()
    _check_scatter_merge_parts_plain_matches_reference()
    _check_scatter_merge_parts_plain_is_per_partition_merge()


def test_partitioned_stream_matches_reference_and_replicated():
    """The stream at n_parts 1, 2, 3 against the reference's partitioned
    engine and the port's replicated one, with ``matched_rows`` and
    ``cem_groups`` on both layouts."""
    _check_stream_matches_reference_and_replicated()


def test_snapshots_and_engine_contracts():
    _check_reference_snapshots_install_into_partitioned()
    _check_engine_contracts()
