"""The port's data and key layer against the reference on the same numpy
inputs: flightgen, Table, coarsening, KeyCodec pack/extract/subcodec/
rollup, the combined sort key, group_by_key, lookup_rows_in_table and
fk_join. Everything here is integer or exact, so every comparison is
exact.
The ``_port_*`` functions hold the port's side; they import torch when
they run, never at collection."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from repro.core import groupby as jgroupby
from repro.core.coarsen import CoarsenSpec as JSpec
from repro.core.coarsen import coarsen as jcoarsen
from repro.core.keys import KeyCodec as JCodec
from repro.data import flightgen as jflightgen
from repro.data.join import fk_join as jfk_join

CARDS = {"a": 16, "b": 3, "c": 200, "d": 2, "e": 1000, "f": 70000}
JOIN_ON = {"airport": 64, "hour": 1 << 17}


def _t(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


def _buckets(rng, n):
    return {k: rng.integers(0, c, n).astype(np.int32) for k, c in CARDS.items()}


# ------------------------------------------------------------------ flightgen
def _port_flightgen(seed):
    from repro_torch.data import flightgen
    a = flightgen.generate(n_flights=3000, n_airports=5, n_days=30, seed=seed,
                           device="cpu")
    tables = {name: getattr(a, name).to_numpy()
              for name in ("weather", "flights", "integrated")}
    return tables, a.true_sate, flightgen.treatment_valid_mask(a, "lowvis")


def _check_flightgen_same_arrays_as_reference(seed):
    tables, true_sate, lowvis = _port_flightgen(seed)
    b = jflightgen.generate(n_flights=3000, n_airports=5, n_days=30,
                            seed=seed)
    for name in ("weather", "flights", "integrated"):
        ta, tb = tables[name], getattr(b, name).to_numpy()
        assert set(ta) == set(tb)
        for k in tb:
            assert ta[k].dtype == tb[k].dtype, (name, k)
            np.testing.assert_array_equal(ta[k], tb[k], err_msg=f"{name}.{k}")
    assert true_sate == b.true_sate
    np.testing.assert_array_equal(
        lowvis, jflightgen.treatment_valid_mask(b, "lowvis"))


def _port_table_round_trip_and_capacity_rule():
    from repro_torch.data.columnar import Table, _round_capacity
    cols = {"x": np.arange(5, dtype=np.float32), "k": np.arange(5) % 2}
    t = Table.from_numpy(cols, valid=np.array([1, 0, 1, 1, 0], bool),
                         device="cpu")
    out = t.to_numpy(compact=True)
    np.testing.assert_array_equal(out["x"], [0, 2, 3])
    assert t.slice(1, 4).nrows == 3
    assert [_round_capacity(n, 1024) for n in (0, 1, 1024, 1025)] == \
        [1024, 1024, 1024, 2048]


# ------------------------------------------------------------------- coarsen
def _port_coarsen(spec, x):
    from repro_torch.core.coarsen import CoarsenSpec, coarsen
    a = (CoarsenSpec.from_cutpoints(spec[1]) if spec[0] == "cut"
         else CoarsenSpec.categorical(spec[1]))
    return coarsen(_t(x), a).numpy(), repr(a)


def _check_coarsen_matches_reference(spec):
    rng = np.random.default_rng(3)
    if spec[0] == "cut":
        b = JSpec.from_cutpoints(spec[1])
        x = rng.normal(0, 2, 500).astype(np.float32)
        x[:4] = spec[1]                  # values ON the cutpoints
    else:
        b = JSpec.categorical(spec[1])
        x = rng.integers(0, spec[1], 500).astype(np.float32)
    got, got_repr = _port_coarsen(spec, x)
    np.testing.assert_array_equal(got, np.asarray(jcoarsen(jnp.asarray(x), b)))
    assert got_repr == repr(b)           # the schema fingerprint relies on it


# ---------------------------------------------------------------------- keys
def _port_codec(bk, valid, sub):
    from repro_torch.core.keys import KeyCodec
    codec = KeyCodec.from_cardinalities(CARDS)
    hi, lo = codec.pack({k: _t(v) for k, v in bk.items()}, _t(valid))
    extracted = {name: codec.extract(hi, lo, name).numpy() for name in CARDS}
    _, shi, slo = codec.rollup(hi, lo, sub, _t(valid))
    return dict(total_bits=codec.total_bits, hi=hi.numpy(), lo=lo.numpy(),
                extracted=extracted, sub_fields=codec.subcodec(sub).fields,
                shi=shi.numpy(), slo=slo.numpy())


def _check_pack_extract_subcodec_rollup_exact():
    rng = np.random.default_rng(0)
    n = 2000
    bk = _buckets(rng, n)
    valid = rng.random(n) > 0.25
    sub = ("a", "c", "f")
    got = _port_codec(bk, valid, sub)
    jcodec = JCodec.from_cardinalities(CARDS)
    assert got["total_bits"] == jcodec.total_bits > 32   # fields straddle
    jhi, jlo = jcodec.pack({k: jnp.asarray(v) for k, v in bk.items()},
                           jnp.asarray(valid))
    np.testing.assert_array_equal(got["hi"], np.asarray(jhi))
    np.testing.assert_array_equal(got["lo"], np.asarray(jlo))
    for name in CARDS:
        np.testing.assert_array_equal(got["extracted"][name][valid],
                                      bk[name][valid])
        np.testing.assert_array_equal(
            got["extracted"][name],
            np.asarray(jcodec.extract(jhi, jlo, name)))
    assert got["sub_fields"] == jcodec.subcodec(sub).fields
    _, jshi, jslo = jcodec.rollup(jhi, jlo, sub, jnp.asarray(valid))
    np.testing.assert_array_equal(got["shi"], np.asarray(jshi))
    np.testing.assert_array_equal(got["slo"], np.asarray(jslo))


def _port_sort_key_orders_lexicographically_with_marker_last():
    from repro_torch.core.keys import sort_key
    words = np.array([[0, 0], [0, 0xFFFFFFFE], [1, 0], [0x7FFFFFFF, 5],
                      [0x80000000, 0], [0xFFFFFFFE, 0xFFFFFFFF],
                      [0xFFFFFFFF, 0xFFFFFFFF]], np.int64)
    k = sort_key(_t(words[:, 0]), _t(words[:, 1])).numpy()
    assert (np.diff(k) > 0).all()
    assert k[-1] == np.iinfo(np.int64).max


# ------------------------------------------------------------------ group by
def _keys_with_duplicates(rng, n):
    bk = {k: rng.integers(0, min(c, 6), n).astype(np.int32)
          for k, c in CARDS.items()}
    valid = rng.random(n) > 0.3
    jhi, jlo = JCodec.from_cardinalities(CARDS).pack(
        {k: jnp.asarray(v) for k, v in bk.items()}, jnp.asarray(valid))
    return np.asarray(jhi), np.asarray(jlo)


def _port_group_by_key(hi, lo):
    from repro_torch.core import groupby
    g = groupby.group_by_key(_t(hi.astype(np.int64)), _t(lo.astype(np.int64)))
    return dict(perm=g.perm.numpy(), seg_ids=g.seg_ids.numpy(),
                group_hi=g.group_hi.numpy(), group_lo=g.group_lo.numpy(),
                group_valid=g.group_valid.numpy(), n_groups=int(g.n_groups),
                inv_perm=g.inv_perm().numpy())


def _check_group_by_key_exact(n):
    rng = np.random.default_rng(n)
    hi, lo = _keys_with_duplicates(rng, n)
    got = _port_group_by_key(hi, lo)
    jg = jgroupby.group_by_key(jnp.asarray(hi), jnp.asarray(lo))
    for k in ("perm", "seg_ids", "group_hi", "group_lo", "group_valid",
              "inv_perm"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jg, k)),
                                      err_msg=k)
    assert got["n_groups"] == int(jg.n_groups)


def _port_lookup(*arrays):
    from repro_torch.core import groupby
    pos, found = groupby.lookup_rows_in_table(
        *(_t(a.astype(np.int64)) for a in arrays))
    return pos.numpy(), found.numpy()


def _check_lookup_rows_in_table_exact():
    rng = np.random.default_rng(11)
    hi, lo = _keys_with_duplicates(rng, 3000)
    jg = jgroupby.group_by_key(jnp.asarray(hi), jnp.asarray(lo))
    # a sorted table of some groups, marker-padded, like a view
    keep = np.asarray(jg.group_valid) & (rng.random(3000) > 0.4)
    th = np.asarray(jg.group_hi)[keep]
    tl = np.asarray(jg.group_lo)[keep]
    th = np.concatenate([th, np.full(37, 0xFFFFFFFF, np.uint32)])
    tl = np.concatenate([tl, np.full(37, 0xFFFFFFFF, np.uint32)])
    qh, ql = _keys_with_duplicates(np.random.default_rng(12), 700)
    pos, found = _port_lookup(qh, ql, th, tl)
    jpos, jfound = jgroupby.lookup_rows_in_table(
        *(jnp.asarray(a) for a in (qh, ql, th, tl)))
    np.testing.assert_array_equal(pos, np.asarray(jpos))
    np.testing.assert_array_equal(found, np.asarray(jfound))
    assert found.any() and not found.all()
    # a full table (no padding): the marker clips to the last slot
    pos, _ = _port_lookup(qh, ql, th[:-37], tl[:-37])
    jpos, _ = jgroupby.lookup_rows_in_table(
        *(jnp.asarray(a) for a in (qh, ql, th[:-37], tl[:-37])))
    np.testing.assert_array_equal(pos, np.asarray(jpos))


# ---------------------------------------------------------------------- join
def _port_fk_join(keep):
    from repro_torch.data import flightgen
    from repro_torch.data.join import fk_join
    a = flightgen.generate(n_flights=2000, n_airports=4, n_days=20, seed=1,
                           device="cpu")
    return fk_join(a.flights, a.weather.filter(_t(keep)), on=JOIN_ON,
                   prefix="w_").to_numpy()


def _check_fk_join_matches_reference():
    b = jflightgen.generate(n_flights=2000, n_airports=4, n_days=20, seed=1)
    # drop some weather rows so some flights miss their dimension row
    keep = np.random.default_rng(0).random(b.weather.nrows) > 0.1
    ja = _port_fk_join(keep)
    jb = jfk_join(b.flights, b.weather.filter(jnp.asarray(keep)), on=JOIN_ON,
                  prefix="w_").to_numpy()
    assert set(ja) == set(jb)
    for k in jb:
        np.testing.assert_array_equal(ja[k], jb[k], err_msg=k)
    assert not ja["_valid"].all()


@pytest.fixture(autouse=True)
def _release_compiled_programs():
    """Drop the worker's compiled XLA programs before and after each test:
    they hold its memory maps (see the module docstring of
    ``tests/test_torch_kernels.py``)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


# ----------------------------------------------------------------- the test
# Few test items on purpose: see ``tests/test_torch_kernels.py``.
def test_data_and_key_layer_match_reference():
    """flightgen, Table, coarsening, KeyCodec, the sort key, group_by_key,
    lookup_rows_in_table and fk_join against the reference, exactly."""
    for seed in (0, 7):
        _check_flightgen_same_arrays_as_reference(seed)
    _port_table_round_trip_and_capacity_rule()
    for spec in (("cut", (-1.0, 0.0, 0.5, 2.0)), ("cat", 7)):
        _check_coarsen_matches_reference(spec)
    _check_pack_extract_subcodec_rollup_exact()
    _port_sort_key_orders_lexicographically_with_marker_last()
    for n in (1, 300, 4099):
        _check_group_by_key_exact(n)
    _check_lookup_rows_in_table_exact()
    _check_fk_join_matches_reference()
