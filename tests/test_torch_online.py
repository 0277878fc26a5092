"""The ported slice as a whole: the reference ``repro.core.OnlineEngine``
(JAX on the CPU) and ``repro_torch``'s engine (``device="cpu"``: the
kernels' plain versions), both with ``reservoir_size=0`` (the reservoir
is held against the reference in ``tests/test_torch_propensity.py``),
take the same flightgen batches — ingests with capacity growth, a
retraction, a bad retraction that both must refuse, a re-ingest — and are
compared after every step:
DeltaReport fields, ``ate()`` per treatment (whole and per airport),
cache counters and ``export_canonical()``. Then the state carry-over:
the reference's snapshot installs into the port and both ingest on.

:func:`_port_run` plays a list of steps on the port's engine and returns
one record per step; the test plays the same steps on the reference
engine and compares record by record. The ``_port_*`` functions import
torch when they run, never at collection.

Tolerances (stated once, used everywhere):

- keys, group validity, overlap keep, touch stamps, count columns
  (``one``, ``t_*``: integers below 2^24 in f32), ``n_groups`` and the
  matched counts: exact.
- outcome sums (``y``, ``yy``, ``yt_*``, ``yyt_*``): |diff| <= 1e-5 times
  the column's largest magnitude. XLA and the port add a group's rows in
  different orders (the port in a pinned pairwise tree); f32 sums of the
  few rows of a group then differ by a few ulps of the largest partial.
- ``ate``, ``att``: rtol 1e-4 — ratios of those sums.
- ``variance``: rtol 1e-3 — it subtracts squared means from second
  moments, which amplifies the sums' relative rounding.
"""
import numpy as np
import jax
import pytest

from repro.core import CoarsenSpec as JSpec
from repro.core import OnlineEngine as JEngine
from repro.data import flightgen as jflightgen
from repro.data.columnar import Table as JTable
from repro.data.join import fk_join as jfk_join

SPEC_RANGES = {"w_precipm": (0, 3), "w_wspdm": (0, 80), "w_tempm": (-20, 40)}
COVARIATES = {
    "thunder": ["w_precipm", "w_wspdm"],
    "snow": ["w_tempm", "w_wspdm"],
    "highwind": ["w_precipm", "w_tempm"],
}
SHARED = ["airport", "carrier", "traffic", "w_season"]
TREATMENTS = {t: SHARED + c for t, c in COVARIATES.items()}
SUBPOPS = (None, {"airport": [0]}, {"airport": [1, 2]})
ENGINE_KW = dict(query_dims=("airport",), granule=128, delta_granule=512)
EST_FIELDS = ("ate", "att", "n_matched_treated", "n_matched_control",
              "n_groups", "variance")


def _specs(S):
    specs = {"airport": S.categorical(16), "carrier": S.categorical(16),
             "traffic": S.equal_width(0, 40, 8),
             "w_season": S.equal_width(0, 1, 4)}
    for name, (lo, hi) in SPEC_RANGES.items():
        specs[name] = S.equal_width(lo, hi, 5)
    return specs


def _batches(sizes=(1000,) * 5, seed=0):
    """Host batches of the example's joined FLIGHTDELAY table, cancelled
    flights masked invalid (they form each delta's pseudo-group). Equal
    sizes keep the reference at one compiled program per capacity."""
    n = sum(sizes)
    d = jflightgen.generate(n_flights=n, n_airports=6, n_days=60, seed=seed)
    j = jfk_join(d.flights, d.weather, on={"airport": 64, "hour": 1 << 17},
                 prefix="w_")
    cols = j.to_numpy()
    valid = cols.pop("_valid") & (cols["cancelled"] == 0)
    edges = np.cumsum((0,) + tuple(sizes))
    return [({k: v[s:e] for k, v in cols.items()}, valid[s:e])
            for s, e in zip(edges[:-1], edges[1:])]


# ----------------------------------------------------- one step, either side
def _step(eng, make_table, step):
    """Play one step on an engine (``make_table`` turns a host batch into
    its table type); return its record. Steps: ("ingest", batch),
    ("retract", batch), ("query",), ("snapshot",), ("stats",), ("cached",
    treatment, subpop). A refused ingest records its error."""
    op = step[0]
    if op in ("ingest", "retract"):
        try:
            rep = eng.ingest(make_table(*step[1]), retract=op == "retract")
        except ValueError as e:
            return dict(error=type(e).__name__)
        return dict(n_rows=rep.n_rows, n_delta_groups=rep.n_delta_groups,
                    fast_path=dict(rep.fast_path),
                    invalidated=tuple(rep.invalidated))
    if op == "query":
        est = {(t, repr(sub)): {f: float(getattr(eng.ate(t, sub), f))
                                for f in EST_FIELDS}
               for t in sorted(TREATMENTS) for sub in SUBPOPS}
        return dict(est=est, hits=eng.cache_hits, misses=eng.cache_misses)
    if op == "snapshot":
        return eng.export_canonical()
    if op == "stats":
        return eng.stats()
    if op == "cached":
        e = eng.cached_estimate(step[1], step[2])
        return None if e is None else float(e.ate)
    raise ValueError(f"unknown step {op!r}")


def _port_engine(**kw):
    from repro_torch.core import CoarsenSpec, OnlineEngine
    return OnlineEngine(_specs(CoarsenSpec), TREATMENTS, outcome="dep_delay",
                        device="cpu", reservoir_size=0, **ENGINE_KW, **kw)


def _port_run(steps, install=None):
    """The port's engine (``device="cpu"``) through ``steps``, optionally
    from an installed snapshot: one record per step."""
    from repro_torch.data.columnar import Table
    eng = _port_engine()
    if install is not None:
        eng.install_canonical(install)
    return [_step(eng, lambda c, v: Table.from_numpy(c, v, device="cpu"), s)
            for s in steps]


def _ref_engine():
    return JEngine(_specs(JSpec), TREATMENTS, outcome="dep_delay",
                   reservoir_size=0, **ENGINE_KW)


# ---------------------------------------------------------------- compare
def _close(a, b, scale, rel):
    assert abs(float(a) - float(b)) <= rel * max(abs(float(b)), scale), \
        (float(a), float(b))


def _assert_report(rt, rj, ordered=True):
    assert rt.keys() == rj.keys(), (rt, rj)
    if "error" in rj:
        assert rt == rj
        return
    for k in ("n_rows", "n_delta_groups", "fast_path"):
        assert rt[k] == rj[k], k
    if ordered:
        assert rt["invalidated"] == rj["invalidated"]
    else:       # an installed cache iterates in the snapshot's key order
        assert sorted(rt["invalidated"], key=repr) == \
            sorted(rj["invalidated"], key=repr)


def _assert_estimates(rt, rj, counters=True):
    for key, ej in rj["est"].items():
        et = rt["est"][key]
        for f in ("n_groups", "n_matched_treated", "n_matched_control"):
            assert et[f] == ej[f], (key, f)
        _close(et["ate"], ej["ate"], 1.0, 1e-4)
        _close(et["att"], ej["att"], 1.0, 1e-4)
        _close(et["variance"], ej["variance"], 1e-3, 1e-3)
    if counters:
        assert (rt["hits"], rt["misses"]) == (rj["hits"], rj["misses"])


def _assert_snapshots(st, sj):
    assert st["fingerprint"] == sj["fingerprint"]
    for k in ("ingest_count", "n_rows_ingested", "delta_cap"):
        assert st["scalars"][k] == sj["scalars"][k], k
    assert set(st["views"]) == set(sj["views"])
    for name, vj in sj["views"].items():
        vt = st["views"][name]
        for k in ("hi", "lo", "touch", "keep"):
            if k in vj:
                assert vt[k].dtype == vj[k].dtype, (name, k)
                np.testing.assert_array_equal(vt[k], vj[k],
                                              err_msg=f"{name}.{k}")
        assert set(vt["stats"]) == set(vj["stats"])
        for k, col in vj["stats"].items():
            got = vt["stats"][k]
            assert got.dtype == np.float32
            if k == "one" or k.startswith("t_"):
                np.testing.assert_array_equal(got, col, err_msg=k)
            else:
                scale = float(np.abs(col).max()) if col.size else 0.0
                np.testing.assert_allclose(got, col, rtol=0,
                                           atol=1e-5 * scale + 1e-6,
                                           err_msg=f"{name}.{k}")


def _assert_records(steps, port, ref, ordered=True, counters=True):
    for step, rt, rj in zip(steps, port, ref):
        op = step[0]
        if op in ("ingest", "retract"):
            _assert_report(rt, rj, ordered)
        elif op == "query":
            _assert_estimates(rt, rj, counters)
        elif op == "snapshot":
            _assert_snapshots(rt, rj)
        elif op == "cached":
            assert rt == rj
    assert len(port) == len(ref) == len(steps)


# ------------------------------------------------------------------ tests
def _check_stream_matches_reference_step_by_step():
    b = _batches()
    check = [("query",), ("query",), ("snapshot",)]   # 2nd query: cache hits
    steps = [("ingest", b[0]), *check,               # grows every view
             ("ingest", b[1]), *check, ("stats",),
             # exact retraction of an ingested batch: the fast path
             ("retract", b[1]), ("query",), ("snapshot",),
             # retracting rows never ingested: refused, state untouched
             ("retract", b[4]), ("snapshot",),
             # re-ingest: the fast path everywhere
             ("ingest", b[1]), ("query",), ("snapshot",)]
    port = _port_run(steps)
    jeng = _ref_engine()
    ref = [_step(jeng, JTable.from_numpy, s) for s in steps]
    _assert_records(steps, port, ref)
    assert port[8]["__base__"]["capacity"] > 128                    # it grew
    assert all(port[9]["fast_path"].values())
    assert port[12] == ref[12] == dict(error="ValueError")
    for name, v in port[11]["views"].items():       # untouched by refusal
        for k, col in v["stats"].items():
            np.testing.assert_array_equal(port[13]["views"][name]["stats"][k],
                                          col)
    assert all(port[14]["fast_path"].values())


def _check_reference_snapshot_installs_into_the_port():
    b = _batches(sizes=(1000,) * 3, seed=1)
    jeng = _ref_engine()
    for batch in b[:2]:
        jeng.ingest(JTable.from_numpy(*batch))
    for t in sorted(TREATMENTS):
        jeng.ate(t)
        jeng.ate(t, {"airport": [0]})
    snap = jeng.export_canonical()
    steps = [("snapshot",), ("cached", "thunder", {"airport": [0]}),
             ("ingest", b[2]), ("snapshot",), ("query",)]
    port = _port_run(steps, install=snap)
    _assert_snapshots(port[0], snap)
    # cached estimates carried over verbatim
    assert port[1] is not None
    assert port[1] == _step(jeng, JTable.from_numpy, steps[1])
    ref = [_step(jeng, JTable.from_numpy, s) for s in steps[2:]]
    _assert_records(steps[2:], port[2:], ref, ordered=False, counters=False)


def _port_fast_path_positions():
    """Every fast-path merge's positions (the scatter-merge kernel's
    input) on a stream with a retraction: returns the duplicate counts,
    after asserting that positions never decrease."""
    from repro_torch.core import fused as fused_mod
    from repro_torch.data.columnar import Table
    seen = []
    merge_fast = fused_mod.merge_fast

    def checked(tname, treatments, st, pos, *args, **kw):
        p = pos.numpy()
        assert (np.diff(p) >= 0).all()
        seen.append(int((np.diff(p) == 0).sum()))
        return merge_fast(tname, treatments, st, pos, *args, **kw)

    fused_mod.merge_fast = checked
    try:
        batches = _batches(sizes=(1000,) * 3, seed=2)
        eng = _port_engine()
        for b in batches:
            eng.ingest(Table.from_numpy(*b, device="cpu"))
        eng.ingest(Table.from_numpy(*batches[0], device="cpu"), retract=True)
        eng.ingest(Table.from_numpy(*batches[0], device="cpu"))
    finally:
        fused_mod.merge_fast = merge_fast
    return seen


def _check_fast_path_positions_are_non_decreasing():
    """The scatter-merge kernel's precondition, on the engine's own fast
    path: positions never decrease, and duplicates (invalid rows of the
    rolled-up deltas) do occur."""
    seen = _port_fast_path_positions()
    assert len(seen) >= 8 and max(seen) > 0


def _port_host_reads_per_ingest_and_query():
    from repro_torch.data.columnar import Table
    batches = _batches(sizes=(1000,), seed=3)
    eng = _port_engine()
    eng.ingest(Table.from_numpy(*batches[0], device="cpu"))
    before = eng.host_reads
    rep = eng.ingest(Table.from_numpy(*batches[0], device="cpu"))
    assert all(rep.fast_path.values())
    assert eng.host_reads - before == 3    # validation, group count, verdicts
    before = eng.host_reads
    eng.ate("thunder")
    eng.ate("thunder")                     # cache hit: no device work
    assert eng.host_reads - before == 1


def _port_segment_sums_cover_valid_groups_only():
    """The delta build and the re-sort merges sum exactly the valid groups
    (the host already reads their counts), never the trailing pseudo-group
    of invalid rows or padding slots."""
    from repro_torch.data.columnar import Table
    from repro_torch.kernels import segment_stats
    calls = []
    segment_sums = segment_stats.segment_sums

    def recorded(values, perm, seg_ids, num_segments):
        calls.append((values.shape[0], num_segments))
        return segment_sums(values, perm, seg_ids, num_segments)

    segment_stats.segment_sums = recorded
    try:
        batches = _batches(sizes=(1000,), seed=5)
        eng = _port_engine()
        rep = eng.ingest(Table.from_numpy(*batches[0], device="cpu"))
    finally:
        segment_stats.segment_sums = segment_sums
    assert not any(rep.fast_path.values())
    rows, segs = calls[0]
    assert segs == rep.n_delta_groups < rows
    state = eng.stats()
    views = ("__base__", *sorted(TREATMENTS))
    assert [n for _, n in calls[-len(views):]] == [
        state[v]["n_groups"] for v in views]


def _port_poison_batch_is_refused_before_any_mutation():
    from repro_torch.core import PoisonBatchError
    from repro_torch.data.columnar import Table
    batches = _batches(sizes=(1000,) * 2, seed=4)
    eng = _port_engine()
    eng.ingest(Table.from_numpy(*batches[0], device="cpu"))
    snap = eng.export_canonical()
    cols, valid = batches[1]
    bad = dict(cols, dep_delay=cols["dep_delay"].copy())
    bad["dep_delay"][np.flatnonzero(valid)[0]] = np.nan
    with pytest.raises(PoisonBatchError, match="non-finite outcome"):
        eng.ingest(Table.from_numpy(bad, valid, device="cpu"))
    bad = dict(cols, airport=cols["airport"].copy())
    bad["airport"][np.flatnonzero(valid)[0]] = 99
    with pytest.raises(PoisonBatchError, match="out of range"):
        eng.ingest(Table.from_numpy(bad, valid, device="cpu"))
    with pytest.raises(PoisonBatchError, match="missing"):
        eng.ingest(Table.from_numpy({"airport": cols["airport"]}, valid,
                                    device="cpu"))
    _assert_snapshots(eng.export_canonical(), snap)


def _port_unported_path_raises(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port_engine(**kw)


def _port_engine_without_device_raises_without_cuda():
    import torch
    from repro_torch.core import CoarsenSpec, OnlineEngine
    available = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            OnlineEngine(_specs(CoarsenSpec), TREATMENTS,
                         outcome="dep_delay")
    finally:
        torch.cuda.is_available = available


@pytest.fixture(autouse=True)
def _release_compiled_programs():
    """Drop the worker's compiled XLA programs before and after each test:
    they hold its memory maps (see the module docstring of
    ``tests/test_torch_kernels.py``)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


# ----------------------------------------------------------------- the tests
# Few test items on purpose: see ``tests/test_torch_kernels.py``.
def test_stream_and_carry_over_match_reference():
    """The ingest / retract / query stream step by step, then the
    reference's snapshot installed into the port."""
    _check_stream_matches_reference_step_by_step()
    _check_reference_snapshot_installs_into_the_port()


def test_engine_contracts():
    """The fast path's non-decreasing positions, host reads per ingest and
    query, segment sums over the valid groups only, poison batches refused before any mutation, unported options
    raising, and no quiet CPU run without a card."""
    _check_fast_path_positions_are_non_decreasing()
    _port_host_reads_per_ingest_and_query()
    _port_segment_sums_cover_valid_groups_only()
    _port_poison_batch_is_refused_before_any_mutation()
    for kw in (dict(mesh=object()), dict(overlap=True),
               dict(pipeline="planner"), dict(query_pipeline="assemble"),
               dict(keep_rows=True)):
        _port_unported_path_raises(kw)
    _port_engine_without_device_raises_without_cuda()
