"""The port's streaming propensity (``repro_torch.core.prng``,
``repro_torch.kernels.logistic_grad``, ``repro_torch.core.propensity`` and
the engine's reservoir) against the reference on the CPU: the same numpy
inputs, made from seeds, go through ``repro`` (JAX on the CPU; its Pallas
kernel in interpret mode) and ``repro_torch`` (``device="cpu"``: the
kernels' plain versions).

Tolerances (stated once, used everywhere):

- threefry uniforms, reservoir columns and priorities, ``n_batches`` and
  the moment count ``n``: bitwise. The port draws the same threefry bits
  and breaks ``top_k``'s ties the same way; no float sum is involved.
- moment sums: rel 1e-6. The reference adds a batch with ``jnp.sum``, the
  port with pinned chunked sums; f32 sums of a few thousand terms in two
  orders differ by a few ulps.
- Newton terms g and H: |diff| <= 1e-5 times the output's largest
  magnitude (XLA's dot against the port's pinned tiles).
- models (``w``, ``mean``, ``std``) and scores: rel 1e-4 (atol 1e-5):
  32 Newton steps over sums that differ in the last bits, plus the
  damping added as ``1e-6 XbᵀXb`` outside the kernel in the port (inside
  the row weights in the reference); ``converged``: equal.

Few test items on purpose: see ``tests/test_torch_kernels.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from repro.core import CoarsenSpec as JSpec
from repro.core import OnlineEngine as JEngine
from repro.core import propensity as jprop
from repro.data.columnar import Table as JTable
from repro.kernels import ref as jref
from repro.kernels.ops import logistic_newton_terms_op as j_newton_op

from test_torch_online import ENGINE_KW, TREATMENTS, _batches, _specs

FEATURES = ["traffic", "w_precipm", "w_wspdm"]


def _t(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _assert_model(mt, mj, rtol=1e-4):
    for f in ("w", "mean", "std"):
        np.testing.assert_allclose(getattr(mt, f).numpy(),
                                   np.asarray(getattr(mj, f)), rtol=rtol,
                                   atol=1e-5, err_msg=f)
    assert bool(mt.converged) == bool(mj.converged)


@pytest.fixture(autouse=True)
def _release_compiled_programs():
    """Drop the worker's compiled XLA programs before and after each test
    (see the module docstring of ``tests/test_torch_kernels.py``)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


# ------------------------------------------------------------- threefry
def test_threefry_uniform_is_bitwise_jax():
    """``prng.uniform(fold_in(prng_key(s), n), N)`` against
    ``jax.random.uniform``: keys equal, draws bitwise equal, for lengths
    that are and are not powers of two up to above 2^16."""
    from repro_torch.core import prng
    cases = [(0, 0, 1), (0, 3, 1000), (7, 12, 37), (1, 1, 1024),
             (123, 4, (1 << 16) + 1001), (2**32 - 1, 99, 5)]
    for s, n, size in cases:
        jkey = jax.random.fold_in(jax.random.PRNGKey(s), n)
        key = prng.fold_in(prng.prng_key(s), n)
        assert key == tuple(int(k) for k in jax.random.key_data(jkey))
        got = prng.uniform(key, size, "cpu").numpy()
        want = np.asarray(jax.random.uniform(jkey, (size,)))
        np.testing.assert_array_equal(_bits(got), _bits(want),
                                      err_msg=str((s, n, size)))
        assert got.min() >= 0.0 and got.max() < 1.0
    # a draw does not depend on its length: a prefix is the shorter draw
    key = prng.fold_in(prng.prng_key(5), 2)
    assert np.array_equal(prng.uniform(key, 3000, "cpu").numpy()[:777],
                          prng.uniform(key, 777, "cpu").numpy())
    with pytest.raises(ValueError):
        prng.prng_key(-1)


# ---------------------------------------------------------- Newton terms
def _newton_inputs(rng, n, d):
    X = rng.normal(0, 1.5, (n, d)).astype(np.float32)
    X[:, -1] = 1.0
    t = (rng.random(n) < 0.35).astype(np.float32)
    m = (rng.random(n) < 0.9).astype(np.float32)
    w = rng.normal(0, 0.7, d).astype(np.float32)
    return X, t, m, w


def _emulate_kernel_partials(V, qb=16):
    """The tile pass of a shared-memory design of
    ``csrc/logistic_grad.cu``, step by step in numpy on the per-row terms
    V (N, Q): per 1024-row tile, thread i holds rows i and i + 512; terms
    reduce qb at a time, each halving step's work item k taking term
    ``k >> lg`` and slot ``k & (h - 1)`` (the register-tree kernel's own
    emulation is in ``tests/test_torch_kernels.py``)."""
    n, q_total = V.shape
    n_tiles = max(1, -(-n // 1024))
    Vp = np.zeros((n_tiles * 1024, q_total), np.float32)
    Vp[:n] = V
    out = np.zeros((n_tiles, q_total), np.float32)
    for tile in range(n_tiles):
        rows = Vp[tile * 1024:(tile + 1) * 1024]
        for q0 in range(0, q_total, qb):
            nq = min(qb, q_total - q0)
            buf = (rows[:512, q0:q0 + nq] + rows[512:, q0:q0 + nq]).T.copy()
            h, lg = 256, 8
            while h > 0:
                k = np.arange(nq * h)
                q, j = k >> lg, k & (h - 1)
                buf[q, j] = buf[q, j] + buf[q, j + h]
                h, lg = h // 2, lg - 1
            out[tile, q0:q0 + nq] = buf[:, 0]
    return out


def test_newton_terms_plain_matches_reference_and_kernel_order():
    """``logistic_newton_terms_plain`` against ``logistic_newton_terms_ref``
    and the Pallas kernel (interpret mode); the kernel's tile loop,
    emulated, against the plain version's tile partials, bitwise; g and H
    symmetric; widths above the kernel's limit refused."""
    import torch
    from repro_torch.kernels import logistic_grad as lg
    from repro_torch.kernels.segment_stats import chunk_sums_plain
    rng = np.random.default_rng(0)
    for n, d in ((1500, 2), (3000, 4), (2049, 9), (7, 1)):
        X, t, m, w = _newton_inputs(rng, n, d)
        g, H = lg.logistic_newton_terms_plain(*map(_t, (X, t, m, w)))
        assert torch.equal(H, H.t())
        jargs = [jnp.asarray(a) for a in (X, t, m, w)]
        for rg, rH in (jref.logistic_newton_terms_ref(*jargs),
                       j_newton_op(*jargs)):
            for a, b in ((g, rg), (H, rH)):
                b = np.asarray(b)
                assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()
        V = lg.newton_row_terms_plain(*map(_t, (X, t, m, w)))
        partials, _ = chunk_sums_plain(V)
        np.testing.assert_array_equal(
            _bits(_emulate_kernel_partials(V.numpy())), _bits(partials))
    with pytest.raises(ValueError, match="outside"):
        lg.logistic_newton_terms(torch.zeros((3, 65)), torch.zeros(3),
                                 torch.zeros(3), torch.zeros(65))


# ---------------------------------------------------------------- models
def test_fit_predict_and_scores_match_reference():
    """Cold fits (own standardization, and stream ``moments=``), a warm
    refit from a reference model carried over by ``model_from_numpy``,
    ``predict_ps`` and ``propensity_scores`` against the reference."""
    from repro_torch.core import propensity as tprop
    from repro_torch.data.columnar import Table
    rng = np.random.default_rng(1)
    n = 3000
    X = np.stack([rng.normal(2, 1, n), rng.exponential(0.05, n),
                  rng.normal(12, 7, n)], 1).astype(np.float32)
    logit = 0.8 * (X[:, 0] - 2) + 9 * X[:, 1] - 0.05 * (X[:, 2] - 12) - 0.7
    t = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    valid = rng.random(n) > 0.1
    jX, jt, jv = jnp.asarray(X), jnp.asarray(t), jnp.asarray(valid)
    tX, tt, tv = _t(X), _t(t), _t(valid)
    mj = jprop.fit_logistic(jX, jt, jv)
    mt = tprop.fit_logistic(tX, tt, tv)
    _assert_model(mt, mj)
    moments = (X[valid].mean(0), X[valid].std(0) * 1.1)
    _assert_model(
        tprop.fit_logistic(tX, tt, tv, n_iter=8,
                           moments=tuple(map(_t, moments))),
        jprop.fit_logistic(jX, jt, jv, n_iter=8,
                           moments=tuple(map(jnp.asarray, moments))))
    # warm refits over drifted data (each column shifted by 0.3 of its
    # std), from the reference's own cold model. The drift keeps the
    # Hessian well conditioned, so the tolerance measures the two
    # packages' rounding and not a solve's amplification of it.
    Xs = (X + np.float32(0.3) * X.std(0)).astype(np.float32)
    start = tprop.model_from_numpy(mj.w, mj.mean, mj.std, mj.converged,
                                   device="cpu")
    for k in (1, 4):
        _assert_model(
            tprop.warm_refit(start, _t(Xs), tt, tv, n_iter=k),
            jprop.warm_refit(mj, jnp.asarray(Xs), jt, jv, n_iter=k))
    np.testing.assert_allclose(tprop.predict_ps(mt, tX).numpy(),
                               np.asarray(jprop.predict_ps(mj, jX)),
                               rtol=1e-4, atol=1e-6)
    cols = {"a": X[:, 0], "b": X[:, 1], "c": X[:, 2], "tr": t}
    ps_t, m_t = tprop.propensity_scores(
        Table.from_numpy(cols, valid, device="cpu"), "tr", ["a", "b", "c"])
    ps_j, m_j = jprop.propensity_scores(JTable.from_numpy(cols, valid), "tr",
                                        ["a", "b", "c"])
    _assert_model(m_t, m_j)
    np.testing.assert_allclose(ps_t.numpy(), np.asarray(ps_j), rtol=1e-4,
                               atol=1e-6)


# ---------------------------------------------------------------- stream
def _assert_stream(st, sj, moments_rtol=1e-6):
    """Port StreamStats ``st`` against reference StreamStats ``sj``."""
    assert st.names == sj.names and st.n_batches == sj.n_batches
    np.testing.assert_array_equal(_bits(st.priority.numpy()),
                                  _bits(sj.priority))
    for c in sj.names:
        np.testing.assert_array_equal(_bits(st.columns[c].numpy()),
                                      _bits(sj.columns[c]), err_msg=c)
        for part in ("sums", "sumsqs"):
            got = getattr(st, part)[st.names.index(c)].item()
            np.testing.assert_allclose(got, float(getattr(sj, part)[c]),
                                       rtol=moments_rtol, atol=1e-6)
    assert st.n.item() == float(sj.n)


def test_stream_stats_match_reference():
    """``StreamStats`` through ingests and retractions, mirroring the
    reference's own tests (``tests/test_online.py``: moments exact and
    retractable; retraction exact; multiplicity and displacement): the
    reservoir bitwise, moments within rel 1e-6, each step."""
    from repro_torch.core.propensity import StreamStats as TStream
    rng = np.random.default_rng(26)
    n = 3000
    x = rng.normal(3.0, 2.0, n).astype(np.float32)
    t = (rng.random(n) < 0.5).astype(np.float32)
    valid = rng.random(n) > 0.2
    sj = jprop.StreamStats.empty(("x", "t"), capacity=512)
    st = TStream.empty(("x", "t"), capacity=512, device="cpu")

    def both(sl, retract=False):
        nonlocal sj, st
        sj = sj.update({"x": jnp.asarray(x[sl]), "t": jnp.asarray(t[sl])},
                       jnp.asarray(valid[sl]), retract=retract)
        st = st.update({"x": _t(x[sl]), "t": _t(t[sl])}, _t(valid[sl]),
                       retract=retract)
        _assert_stream(st, sj)

    for s in range(0, n, 500):
        both(slice(s, s + 500))
    mean, std = st.moments(["x"])
    np.testing.assert_allclose(mean.item(), x[valid].mean(), rtol=1e-5)
    np.testing.assert_allclose(std.item(), x[valid].std(), rtol=1e-4)
    both(slice(0, 500), retract=True)           # full reservoir: displaced
    both(slice(2500, 3000), retract=True)       # newest rows: sampled
    keep = valid.copy()
    keep[:500] = keep[2500:] = False
    mean, _ = st.moments(["x"])
    np.testing.assert_allclose(mean.item(), x[keep].mean(), rtol=1e-5)
    both(slice(2500, 3000))                     # re-ingest
    # duplicated row values: retracting ONE copy removes exactly one slot
    sj = jprop.StreamStats.empty(("x", "t"), capacity=64)
    st = TStream.empty(("x", "t"), capacity=64, device="cpu")
    x = np.array([1, 2, 2, 3, 2], np.float32)
    t = np.array([0, 1, 1, 0, 0], np.float32)
    valid = np.ones(5, bool)
    both(slice(0, 5))
    both(slice(1, 2), retract=True)
    cols, rvalid = st.reservoir()
    left = sorted(cols["x"][rvalid].tolist())
    assert left == [1.0, 2.0, 2.0, 3.0]
    # retract-then-refit equals never-ingested-then-fit, bit for bit
    A = rng.integers(0, 5, (1500, 2)).astype(np.float32)
    A[:, 1] = np.arange(1500)
    tA = (rng.random(1500) < 0.4).astype(np.float32)
    vA = rng.random(1500) > 0.08
    never = TStream.empty(("a", "y", "t"), capacity=4096, device="cpu")
    engine = never

    def batch(lo, hi):
        return {"a": _t(A[lo:hi, 0]), "y": _t(A[lo:hi, 1]),
                "t": _t(tA[lo:hi])}, _t(vA[lo:hi])

    never = never.update(*batch(0, 1000))
    engine = engine.update(*batch(0, 1000)).update(*batch(1000, 1500))
    engine = engine.update(*batch(1000, 1500), retract=True)
    assert np.array_equal(never.priority.numpy(), engine.priority.numpy())
    assert np.array_equal(never.res.numpy(), engine.res.numpy())


# ---------------------------------------------------------------- engine
def _port_engine(**kw):
    from repro_torch.core import CoarsenSpec, OnlineEngine
    return OnlineEngine(_specs(CoarsenSpec), TREATMENTS, outcome="dep_delay",
                        device="cpu", **ENGINE_KW, **kw)


def _ref_engine(**kw):
    return JEngine(_specs(JSpec), TREATMENTS, outcome="dep_delay",
                   **ENGINE_KW, **kw)


def _port_table(batch):
    from repro_torch.data.columnar import Table
    return Table.from_numpy(*batch, device="cpu")


def _ingest_both(pe, je, batch, retract=False):
    """The same step on both engines; returns whether each refused it."""
    out = []
    for eng, table in ((pe, _port_table(batch)),
                       (je, JTable.from_numpy(*batch))):
        try:
            eng.ingest(table, retract=retract)
            out.append(False)
        except ValueError:
            out.append(True)
    assert out[0] == out[1]
    return out[0]


def _assert_stream_sections(st, sj):
    for k in ("n_batches", "capacity"):
        assert st[k] == sj[k], k
    np.testing.assert_array_equal(_bits(st["pri"]), _bits(sj["pri"]))
    assert float(st["n"]) == float(sj["n"])
    assert st["res"].keys() == sj["res"].keys()
    for c in sj["res"]:
        np.testing.assert_array_equal(_bits(st["res"][c]),
                                      _bits(sj["res"][c]), err_msg=c)
        for part in ("sums", "sumsqs"):
            np.testing.assert_allclose(float(st[part][c]),
                                       float(sj[part][c]), rtol=1e-6)


def test_engine_stream_and_refresh_match_reference():
    """Engines of both packages with the reservoir (256 slots, so it fills
    and displaces) through ingests, an exact retraction, a refused
    retraction and a re-ingest: the stream section bitwise after every
    step, cold and warm ``refresh_propensity`` within tolerance. Then:
    default engines' fingerprints agree; snapshots with a stream section
    cross both ways and the receiver continues the stream bitwise;
    ``host_reads`` per ingest does not depend on the reservoir; a poison
    batch and a refused retraction leave the stream untouched."""
    from repro_torch.core import PoisonBatchError
    b = _batches(sizes=(1000,) * 5, seed=7)
    pe, je = _port_engine(reservoir_size=256), _ref_engine(reservoir_size=256)
    assert pe.schema_fingerprint() == je.schema_fingerprint()
    steps = [(b[0], False), (b[1], False), (b[2], False), (b[1], True),
             (b[4], True), (b[1], False)]
    refused = []
    for i, (batch, retract) in enumerate(steps):
        refused.append(_ingest_both(pe, je, batch, retract))
        _assert_stream_sections(pe.export_canonical()["stream"],
                                je.export_canonical()["stream"])
        if i == 2:       # cold fit over a full reservoir
            _assert_model(pe.refresh_propensity("thunder", FEATURES),
                          je.refresh_propensity("thunder", FEATURES))
    assert refused == [False, False, False, False, True, False]
    assert pe.stream.n_batches == 5
    _assert_model(pe.refresh_propensity("thunder", FEATURES),   # warm
                  je.refresh_propensity("thunder", FEATURES))

    # default engines: the 8192-slot reservoir and the same fingerprint
    from repro_torch.core import CoarsenSpec, OnlineEngine
    dflt = OnlineEngine(_specs(CoarsenSpec), TREATMENTS, outcome="dep_delay",
                        device="cpu")
    assert dflt.stream.capacity == 8192
    assert dflt.schema_fingerprint() == JEngine(
        _specs(JSpec), TREATMENTS, outcome="dep_delay").schema_fingerprint()

    # snapshots cross both ways; the receiver continues bitwise
    to_port, to_ref = _port_engine(reservoir_size=256), \
        _ref_engine(reservoir_size=256)
    to_port.install_canonical(je.export_canonical())
    to_ref.install_canonical(pe.export_canonical())
    with pytest.raises(ValueError, match="mismatch"):
        _port_engine(reservoir_size=0).install_canonical(
            je.export_canonical())
    for batch in (b[3], b[0]):
        _ingest_both(to_port, je, batch)
        _ingest_both(pe, to_ref, batch)
    _assert_stream_sections(to_port.export_canonical()["stream"],
                            je.export_canonical()["stream"])
    _assert_stream_sections(pe.export_canonical()["stream"],
                            to_ref.export_canonical()["stream"])

    # host reads per ingest: the reservoir adds none
    reads = []
    for size in (0, 256):
        eng = _port_engine(reservoir_size=size)
        eng.ingest(_port_table(b[0]))
        before = eng.host_reads
        eng.ingest(_port_table(b[0]))
        eng.ingest(_port_table(b[0]), retract=True)
        reads.append(eng.host_reads - before)
    assert reads[0] == reads[1] == 3 + 4

    # a poison batch and a refused retraction leave the stream untouched
    before = pe.export_canonical()["stream"]
    cols, valid = b[2]
    bad = dict(cols, dep_delay=cols["dep_delay"].copy())
    bad["dep_delay"][np.flatnonzero(valid)[0]] = np.inf
    with pytest.raises(PoisonBatchError):
        pe.ingest(_port_table((bad, valid)))
    with pytest.raises(ValueError, match="never ingested"):
        pe.ingest(_port_table(b[4]), retract=True)
    _assert_stream_sections(pe.export_canonical()["stream"], before)
