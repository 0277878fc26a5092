#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; each one that fails exits non-zero:

1. Print the card's name and power limit (``nvidia-smi``).
2. Build the eight CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all started together).
3. The main path, at a size users run: 2^22 FLIGHTDELAY flights from the
   port's generator, joined to weather with ``fk_join`` (cancelled flights
   masked invalid), streamed as 16 batches of 2^18 rows into the default
   ``OnlineEngine`` (its 8192-row streaming-propensity reservoir on) on
   ``cuda`` with the specs and treatments of
   ``examples/online_flight_delay.py``; a cold ``refresh_propensity`` of
   ``thunder`` after the 16 ingests; then one batch retracted and
   re-ingested and a warm refresh (the example's call); ``ate()`` for each
   treatment, whole and for 4 airports, after every ingest; last,
   ``propensity_scores`` of ``thunder`` over the whole 2^22-row joined
   relation. Every kernel launch counter is set to 0 just before this
   phase and read just after it: each of the five kernels of the
   replicated path must have launched. The same path then runs through
   the port on the CPU (the
   kernels' plain versions) and the two are held against each other:
   keys, counts, masks, touch stamps, group counts, the reservoir and the
   stream moments exactly, float sums, estimates and propensity models
   within stated tolerances.
   The partitioned layout: the same stream (ingests, cold refresh,
   retraction, re-ingest, warm refresh, queries) through
   ``PartitionedOnlineEngine(n_parts=4)`` on ``cuda``, the launch counters
   set to 0 just before and read just after it: ``scatter_merge_parts``
   must have launched (the retraction's and the re-ingest's fast-path
   merges), ``scatter_merge`` never, every other kernel of the path at
   least once. Its state (every ``export_canonical`` field, the reservoir
   included), every estimate of every step and both refreshed models must
   equal the replicated card engine's bit for bit, and so must
   ``matched_rows`` of every treatment over one batch.
   The offline path (the paper's Table 3, ``benchmarks/bench_quality.py``,
   treatment ``snow``), the launch counters set to 0 just before and read
   just after it: on the whole 2^22-row relation, CEM (the Table 3 specs)
   and EM (airport, carrier) with ``estimate_ate`` and its variance, the
   difference in means, the raw imbalance, ``propensity_scores``, NNMWR on
   the propensity distance (1-D engine, k = 1, caliper 0.001) with its
   ATT, subclassification (5 subclasses, trim 0.1 / 0.9), AWMD of the
   Table 3 covariates; on its first 2^17 rows (a random sample), the
   Mahalanobis rotation of the five propensity features, NNMWR (k = 1,
   caliper 0.5) and NNMNR (k = 1, m = 8) on the quadratic engine — one
   2^17 x 2^17 ``knn_topk`` launch each, and a sweep over 2^17 x 8 edges —
   and NNMNR on the propensity distance. ``knn_topk`` and
   ``greedy_sweep`` must launch on it and on no other path. The same
   calls then run through the port on the CPU: part 1 given the card's
   scores, part 2 on the first 2^14 rows given the card's rotation (and
   the card reruns them there); masks, keys, group ids, counts, matched
   indices, distances, ``ok`` and taken sets must be equal, estimates
   within the tolerances below, the fitted model within RTOL_MODEL.
4. Each kernel against its plain PyTorch version on the card, at the
   shapes the main path gave it, with timings of the kernel, the plain
   version and a PyTorch library yardstick computing the same function
   (where there is one), and the least time the card could take;
   ``cem_keys`` through the paths' call ``cem_keys_columns`` (the batch's
   named columns in their own dtypes, read where they lie) at the
   replicated ingest's 2^18 x 7 and at the offline ``cem()`` call's
   2^22 x 4, bit for bit its plain version over the stacked f32 columns,
   one device operation a call, timed by CUDA events and by the profiler
   beside the route the paths took before (``torch.stack`` of the f32
   conversions, then the matrix form), with its launches on each of the
   three paths, the host microseconds of a call split into its guards,
   allocation, packing and ``Kernel.launch`` (beside ``Kernel.launch`` as
   it was before it read PyTorch's raw stream handle) and the pieces of a
   launch; the tree kernels (``segment_sums``, ``scatter_merge``,
   ``scatter_merge_parts``) bit for bit as integer views (-0.0 is not
   +0.0), with their device time by kernel from the profiler beside the
   event-timed ms, ``segment_sums`` also at the shape of an uncached
   query's canonical re-sort and at the offline path's (the subclass
   groups over the 2^22 rows, and that call's longest run alone), and the
   trailing pseudo-group of invalid rows alone;
   ``chunk_sums`` bit for bit at the query's shape (10,240 x 5) and at the
   propensity standardisation's (2^22 x 4), timed by CUDA events and by
   the profiler beside ``torch.sum`` over the zero-padded reshape, with
   the host microseconds per call of both (1,000 calls, one synchronise)
   and of the steps of the wrapper, ``Kernel.launch`` beside its earlier
   form;
   ``logistic_newton_terms`` at both of its shapes (the reservoir,
   8192 x 4, and the whole relation, 2^22 x 4), run twice to show
   bitwise repeatability, and timed by CUDA events and by the profiler;
   each call of these two wrappers must be one device operation.
   ``scatter_merge_parts`` at the shapes of the partitioned retraction's
   view merge. ``knn_topk`` bit for bit against its plain version on
   8,192 queries of the 2^17-row sample against all its controls, at k = 1
   and k = 8, and timed there and at the path's 2^17 x 2^17 (with
   ``torch.cdist(...).topk(k)`` over the path's 16 slabs of 8,192 queries,
   summed, as its yardstick);
   the launch it plans there (R queries a thread, S control ranges, the
   block counts) printed as the ``knn_topk_launch`` line;
   ``greedy_sweep`` bit for bit on the sample's and the path's edges, on
   the path's rows at a wide caliper and on the dense shape (those
   candidates with every row treated), with the count of edges below BIG
   in each set (the ``greedy_sweep_edges`` line), timed in turns with the
   one-thread kernel it replaced on the path's and the dense edges; both rows' ``max_abs_err`` are the
   largest |kernel - plain| those comparisons measured.
   Then steady-state repeats of the propensity path (cold and
   warm fits over the reservoir, ``propensity_scores``), and the main
   path's stream six times more, in turns on the same card: replicated
   without and with the reservoir, partitioned, replicated, partitioned,
   replicated without (``reservoir_size`` 0, 8192, 8192 at n_parts=4,
   8192, 8192 at n_parts=4, 0), for the ingest and query medians of each
   configuration.
5. One steady-state window under ``torch.profiler`` for each layout (a
   retraction and re-ingest of one batch, then a step's 15 uncached
   queries): the device-busy share and the ops that took the most device
   time.
6. Print ``{"kernels": [...]}``, then, last, the ``{"ok": true, ...}``
   line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_FLIGHTS = 1 << 22
BATCH = 1 << 18
AIRPORTS = (0, 1, 2, 3)
SPEC_RANGES = {"w_precipm": (0, 3), "w_wspdm": (0, 80), "w_tempm": (-20, 40)}
COVARIATES = {
    "thunder": ["w_precipm", "w_wspdm"],
    "snow": ["w_tempm", "w_wspdm"],
    "highwind": ["w_precipm", "w_tempm"],
}
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and f32 rate
# outside the tensor cores. Every kernel here is f32 / integer work.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# Tolerances of the GPU-vs-CPU comparison of the port. Counts are integers
# below 2^24 in f32 and the kernels pin every summation order, so both runs
# are expected to agree bit for bit; the float tolerances below only bound
# a difference in elementwise rounding between the two devices' math
# libraries, should one appear.
RTOL_SUMS = 1e-6
RTOL_EST = 1e-5
RTOL_VAR = 1e-4
# Propensity models, card against CPU: 32 Newton steps whose g and H agree
# up to the devices' exp (and their BLAS for the constant damping term
# and LAPACK for the 4 x 4 solve), so w, mean and std within rel 1e-4;
# ``converged`` equal. The Newton-terms kernel against its plain version
# on the card: rel 1e-6 of each output's largest magnitude (the kernel's
# expf against torch.exp; every sum order is pinned).
RTOL_MODEL = 1e-4
RTOL_NEWTON = 1e-6
PROPENSITY = ("thunder", ("traffic", "w_precipm", "w_wspdm"))
# the partition count a 4-card mesh would hold; on one card it gives the
# partitioned merge kernel P > 1
N_PARTS = 4
# the kernels each path must launch; any other kernel launched on a path
# fails it
PATH_KERNELS = {
    "replicated": ("cem_keys", "segment_sums", "scatter_merge", "chunk_sums",
                   "logistic_newton_terms"),
    "partitioned": ("cem_keys", "segment_sums", "scatter_merge_parts",
                    "chunk_sums", "logistic_newton_terms"),
    "offline": ("cem_keys", "segment_sums", "chunk_sums",
                "logistic_newton_terms", "knn_topk", "greedy_sweep"),
}
# The offline path: the methods of the paper's Table 3
# (benchmarks/bench_quality.py), treatment snow, on the main path's joined
# relation; the quadratic Mahalanobis matching on its first 2^17 rows (a
# random sample: the generator draws flights in random order), the
# card-against-CPU comparison of that part on its first 2^14 rows, and the
# k-NN kernel against its plain version on 8,192 queries of the 2^17.
OFFLINE_T = "snow"
OFFLINE_Y = "dep_delay"
PS_FEATURES = ("traffic", "w_season", "w_tempm", "w_wspdm", "w_precipm")
BALANCE_COVS = ("w_visim", "w_wspdm", "traffic", "carrier_traffic")
EM_COVS = {"airport": 16, "carrier": 16}
PS_CALIPER = 0.001
SUBCLASS_TRIM = (0.1, 0.9)
MAHALANOBIS_CALIPER = 0.5
MATCH_ROWS = 1 << 17
CPU_MATCH_ROWS = 1 << 14
KNN_SLAB = 8192
# a caliper above every Mahalanobis distance of the sample (finite: at
# 1.84e19 or more the reference takes unfilled slots as matches)
WIDE_CALIPER = 1e6

KERNEL_FILES = {
    "cem_keys": ("src/repro_torch/csrc/cem_keys.cu",
                 "src/repro/kernels/cem_keys.py:48"),
    "segment_sums": ("src/repro_torch/csrc/segment_sums.cu",
                     "src/repro/kernels/segment_stats.py:31"),
    "scatter_merge": ("src/repro_torch/csrc/scatter_merge.cu",
                      "src/repro/kernels/segment_stats.py:68"),
    "scatter_merge_parts": ("src/repro_torch/csrc/scatter_merge_parts.cu",
                            "src/repro/kernels/segment_stats.py:118"),
    "chunk_sums": ("src/repro_torch/csrc/chunk_sums.cu",
                   "src/repro/kernels/segment_stats.py:186"),
    "logistic_newton_terms": ("src/repro_torch/csrc/logistic_grad.cu",
                              "src/repro/kernels/logistic_grad.py:41"),
    "knn_topk": ("src/repro_torch/csrc/knn_topk.cu",
                 "src/repro/kernels/knn_topk.py:62"),
    # not a TPU kernel: the lax.scan of greedy_nnmnr
    "greedy_sweep": ("src/repro_torch/csrc/greedy_sweep.cu",
                     "src/repro/core/matching.py:190"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check_launches(path: str, counts: dict) -> None:
    """Every kernel of ``path`` launched, and no other kernel."""
    missing = [k for k in PATH_KERNELS[path] if not counts[k]]
    if missing:
        fail(f"kernels never launched on the {path} path: {missing}")
    stray = [k for k, v in counts.items() if v and k not in PATH_KERNELS[path]]
    if stray:
        fail(f"the {path} path launched {stray}: {counts}")


def build_specs(CoarsenSpec):
    specs = {
        "airport": CoarsenSpec.categorical(16),
        "carrier": CoarsenSpec.categorical(16),
        "traffic": CoarsenSpec.equal_width(0, 40, 8),
        "w_season": CoarsenSpec.equal_width(0, 1, 4),
    }
    for name, (lo, hi) in SPEC_RANGES.items():
        specs[name] = CoarsenSpec.equal_width(lo, hi, 5)
    return specs


def timed(torch, fn, reps: int, warmup: int = 3) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls (CUDA events,
    after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int = 20) -> dict:
    """Device time per call of ``fn``, by kernel, under ``torch.profiler``
    (after one warm-up call): what the card spends, without the host's
    launch overhead that a CUDA-event loop of a short call measures; and
    the device operations (kernels, memsets, copies) per call. Kernel
    names are cut at their first parenthesis."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a window in which the profiler recorded no device activity at all
    # (it happens now and then) is profiled again, at most twice
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        ops = 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total:
                name = e.key.split("(")[0][-60:]
                out[name] = out.get(name, 0.0) + \
                    e.self_device_time_total / 1e3 / reps
                ops += e.count
        if out:
            break
    return dict(total=sum(out.values()), by_kernel=out,
                ops_per_call=ops / reps)


def same_floats(torch, a, b) -> bool:
    """Bit for bit (``torch.equal`` takes -0.0 for +0.0)."""
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def device_split(torch, fn) -> dict:
    """``device_ms`` of ``fn`` as (total, by kernel, ops per call), kernel
    names cut to their first 40 characters."""
    d = device_ms(torch, fn)
    return dict(device_ms=d["total"],
                device_by_kernel={k[:40]: v for k, v in
                                  d["by_kernel"].items()},
                device_ops_per_call=d["ops_per_call"])


def one_op(name: str, split: dict) -> None:
    """A wrapper whose call must be one device operation: its kernel."""
    if split["device_ops_per_call"] != 1:
        fail(f"{name}: {split['device_ops_per_call']} device operations "
             f"per call, not 1: {split['device_by_kernel']}")


def host_us(torch, fn, calls: int = 1000) -> float:
    """Host microseconds per call of ``fn``: ``calls`` calls with no
    synchronise between them, then one (after a warm-up and a sync)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------- main path
def host_model(model) -> dict:
    """A propensity model's tensors on the host."""
    return {f: getattr(model, f).cpu().numpy()
            for f in ("w", "mean", "std", "converged")}


def run_stream(torch, engine_cls, specs, treatments, batches, device,
               reservoir_size=8192, **engine_kw):
    """The main path's stream on one device, through ``engine_cls``
    (``OnlineEngine``, or ``PartitionedOnlineEngine`` with ``n_parts`` in
    ``engine_kw``). Returns (engine, estimates per step, ingest ms list,
    query ms list, the refreshed models (cold, warm) on the host, refresh
    ms list). ``reservoir_size=0`` runs the ingests and queries alone (no
    refresh)."""
    eng = engine_cls(specs, treatments, outcome="dep_delay",
                     query_dims=("airport",), reservoir_size=reservoir_size,
                     device=device, **engine_kw)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    estimates, ingest_ms, query_ms = [], [], []
    models, refresh_ms = [], []

    def refresh():
        if not reservoir_size:
            return
        sync()
        t0 = time.perf_counter()
        model = eng.refresh_propensity(PROPENSITY[0], list(PROPENSITY[1]))
        sync()
        refresh_ms.append((time.perf_counter() - t0) * 1e3)
        models.append(host_model(model))

    def step(batch, retract=False):
        sync()
        t0 = time.perf_counter()
        eng.ingest(batch, retract=retract)
        sync()
        ingest_ms.append((time.perf_counter() - t0) * 1e3)
        row = {}
        for t in sorted(treatments):
            for sub in (None, *AIRPORTS):
                pop = None if sub is None else {"airport": [sub]}
                t0 = time.perf_counter()
                est = eng.ate(t, pop)
                query_ms.append((time.perf_counter() - t0) * 1e3)
                row[(t, sub)] = est
        estimates.append(row)

    for b in batches:
        step(b)
    refresh()                                    # cold: 32 Newton steps
    step(batches[0], retract=True)
    step(batches[0])
    refresh()                                    # warm: 4 steps
    return eng, estimates, ingest_ms, query_ms, models, refresh_ms


def run_scores(torch, propensity_scores, table):
    """``propensity_scores`` of the main path's treatment over the whole
    joined relation. Returns (scores, model, ms)."""
    sync = (torch.cuda.synchronize if table.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    ps, model = propensity_scores(table, PROPENSITY[0], list(PROPENSITY[1]))
    sync()
    return ps, model, (time.perf_counter() - t0) * 1e3


def stream_op_counts(torch, eng, batch) -> dict:
    """Device operations (aten ops, counted by a dispatch mode; each is a
    kernel launch or a view) that one batch's streaming-propensity step
    issues: the threefry draw of its priorities alone, and the whole update
    and retraction. The steps run on the engine's stream without
    committing (they are pure)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core import fused as fused_mod
    from repro_torch.core import prng

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    cols = {c: batch.columns[c] for c in eng._row_cols}
    key = prng.fold_in(prng.prng_key(eng.seed), eng.stream.n_batches)
    out = {}
    for name, fn in (
            ("threefry_uniform",
             lambda: prng.uniform(key, batch.nrows, eng.device)),
            ("stream_update",
             lambda: fused_mod.stream_step(eng.stream, cols, batch.valid,
                                           False)),
            ("stream_retract",
             lambda: fused_mod.stream_step(eng.stream, cols, batch.valid,
                                           True))):
        with Count() as count:
            fn()
        out[name] = count.n
    return out


def compare_models(np, label, mg, mc):
    """Card model against CPU model; returns the largest relative
    difference."""
    if bool(mg["converged"]) != bool(mc["converged"]):
        fail(f"{label}: converged differs between cuda and cpu")
    worst = 0.0
    for f in ("w", "mean", "std"):
        g, c = mg[f], mc[f]
        if not np.isfinite(g).all():
            fail(f"{label}: {f} is not finite")
        rel = float(np.max(np.abs(g - c) / np.maximum(np.abs(c), 1e-3)))
        worst = max(worst, rel)
        if rel > RTOL_MODEL:
            fail(f"{label}: {f} {g} vs {c} beyond rtol {RTOL_MODEL}")
    return worst


def compare_streams(np, sg, sc):
    """The reservoir, priorities, moments and batch counter, card against
    CPU: bit for bit."""
    for k in ("n_batches", "capacity"):
        if sg[k] != sc[k]:
            fail(f"stream {k} differs: {sg[k]} vs {sc[k]}")
    for k in ("pri", "n"):
        if not np.array_equal(np.asarray(sg[k]).view(np.uint32),
                              np.asarray(sc[k]).view(np.uint32)):
            fail(f"stream {k} differs between cuda and cpu")
    for part in ("res", "sums", "sumsqs"):
        for c, col in sc[part].items():
            if not np.array_equal(np.asarray(sg[part][c]).view(np.uint32),
                                  np.asarray(col).view(np.uint32)):
                fail(f"stream {part}[{c}] differs between cuda and cpu")
    return dict(filled=int((sg["pri"] > -np.inf).sum()),
                n=float(sg["n"]), n_batches=sg["n_batches"])


def compare_runs(np, gpu_eng, cpu_eng, gpu_est, cpu_est):
    """Hold the GPU run against the CPU run; returns a summary dict."""
    s_g, s_c = gpu_eng.export_canonical(), cpu_eng.export_canonical()
    bitwise = True
    for name, vc in s_c["views"].items():
        vg = s_g["views"][name]
        for k in ("hi", "lo", "touch", "keep"):
            if k in vc and not np.array_equal(vg[k], vc[k]):
                fail(f"view {name}: {k} differs between cuda and cpu")
        for k, col in vc["stats"].items():
            g = vg["stats"][k]
            if k == "one" or k.startswith("t_"):
                if not np.array_equal(g, col):
                    fail(f"view {name}: count column {k} differs")
            elif not np.allclose(g, col, rtol=RTOL_SUMS, atol=1e-3):
                fail(f"view {name}: stat {k} beyond rtol {RTOL_SUMS}")
            bitwise &= bool(np.array_equal(g.view(np.uint32),
                                           col.view(np.uint32)))
    if s_g["scalars"]["ingest_count"] != s_c["scalars"]["ingest_count"]:
        fail("ingest counts differ")
    max_rel = 0.0
    for rg, rc in zip(gpu_est, cpu_est):
        for key, ec in rc.items():
            eg = rg[key]
            for f in ("n_groups", "n_matched_treated", "n_matched_control"):
                if getattr(eg, f) != getattr(ec, f):
                    fail(f"{key}: {f} differs")
            for f, tol in (("ate", RTOL_EST), ("att", RTOL_EST),
                           ("variance", RTOL_VAR)):
                a, b = float(getattr(eg, f)), float(getattr(ec, f))
                if not np.isfinite(a):
                    fail(f"{key}: {f} is not finite")
                rel = abs(a - b) / max(abs(b), 1e-6)
                max_rel = max(max_rel, rel)
                if rel > tol:
                    fail(f"{key}: {f} {a} vs {b} beyond rtol {tol}")
                bitwise &= a == b
    return dict(bitwise=bitwise, max_rel_estimate_diff=max_rel,
                groups={k: len(v["hi"]) for k, v in s_g["views"].items()},
                stream=compare_streams(np, s_g["stream"], s_c["stream"]))


def same_bits(np, a, b, path, diffs):
    """Append to ``diffs`` every leaf of two snapshots (nested dicts of
    arrays and scalars) whose bits differ."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            diffs.append(f"{path}: keys differ")
            return
        for k in a:
            same_bits(np, a[k], b[k], f"{path}.{k}", diffs)
    elif isinstance(a, (tuple, list)):
        if len(a) != len(b):
            diffs.append(f"{path}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            same_bits(np, x, y, f"{path}[{i}]", diffs)
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(
                a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)):
            diffs.append(path)
    elif a != b:
        diffs.append(path)


def compare_layouts(torch, np, part, rep, batch, treatments):
    """The partitioned card run against the replicated card run, bit for
    bit: every ``export_canonical`` field (views, reservoir, moments,
    counters, cache), every estimate of every step, both refreshed models,
    and ``matched_rows`` of every treatment over ``batch``. ``part`` and
    ``rep`` are (engine, estimates, models)."""
    diffs = []
    same_bits(np, part[0].export_canonical(), rep[0].export_canonical(),
              "snapshot", diffs)
    for i, (rp, rr) in enumerate(zip(part[1], rep[1])):
        for key, er in rr.items():
            for f in ("ate", "att", "variance", "n_groups",
                      "n_matched_treated", "n_matched_control"):
                same_bits(np, np.asarray(getattr(part[1][i][key], f)),
                          np.asarray(getattr(er, f)), f"step {i} {key} {f}",
                          diffs)
    same_bits(np, list(part[2]), list(rep[2]), "models", diffs)
    matched = {}
    for t in sorted(treatments):
        mp = part[0].matched_rows(t, batch)
        mr = rep[0].matched_rows(t, batch)
        if not torch.equal(mp, mr):
            diffs.append(f"matched_rows {t}")
        matched[t] = int(mr.sum())
    if diffs:
        fail(f"partitioned differs from replicated: {diffs[:10]}")
    return dict(bitwise=True, steps=len(rep[1]), matched_rows=matched,
                probe_rows=batch.nrows)


# ------------------------------------------------------- kernel checks
def kernel_checks(torch, np, eng, batch, counts):
    """Each kernel against its plain version at main-path shapes."""
    from repro_torch.core import cube as cube_mod
    from repro_torch.core import groupby
    from repro_torch.core import fused as fused_mod
    from repro_torch.kernels import segment_stats as ss
    from repro_torch.kernels.ops import cem_keys_columns

    out = []
    dev = eng.device
    cols = {c: batch.columns[c] for c in eng._row_cols}
    tab = eng._cutpoints
    valid = batch.valid
    n = valid.shape[0]
    tn = eng._tnames

    def record(name, err, ms, plain_ms, lib_ms, n_bytes, n_ops, shapes):
        b, by = bound_ms(n_bytes, n_ops)
        src, rep = KERNEL_FILES[name]
        out.append(dict(name=name, route="cuda", source=src, replaces=rep,
                        launches=counts[name], max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, bound_ms=b, bound_us=b * 1e3,
                        bound_by=by, library_ms=lib_ms, shapes=shapes))

    # cem_keys: the path call on the batch's named columns, (2^18, 7)
    ingest = cem_keys_shape(torch, cols, valid, tab)
    kh, kl = cem_keys_columns(cols, valid, tab)
    record("cem_keys", ingest["max_abs_err"], ingest["ms"],
           ingest["plain_ms"], None, ingest["bytes_needed"],
           ingest["compares"], dict(ingest=ingest))
    out[-1].update({k: ingest[k] for k in (
        "device_ms", "device_by_kernel", "device_ops_per_call")})
    out[-1]["host_split_us"] = cem_keys_host_split(torch, cols, valid, tab)

    # segment_sums: the delta build's group-by, (2^18, 12), over the
    # G valid groups as the engine calls it (the trailing pseudo-group of
    # invalid rows is not summed)
    g = groupby.group_by_key(kh, kl)
    vals = cube_mod.delta_stat_columns(cols, valid, tn, eng.outcome)
    s = vals.shape[1]
    n_delta = int(g.n_groups)
    n_inv = int((~valid).sum())
    sargs = (vals, g.perm, g.seg_ids, n_delta)
    k_out = ss.segment_sums(*sargs)
    p_out = ss.segment_sums_plain(*sargs)
    err = float((k_out - p_out).abs().max())
    if not same_floats(torch, k_out, p_out):
        fail(f"segment_sums differs from its plain version ({err})")
    # the library call adds every row, the invalid ones into row G
    seg_orig = g.seg_ids[g.inv_perm()]
    zeros = torch.zeros((n_delta + 1, s), dtype=torch.float32, device=dev)
    summed = n - n_inv
    record("segment_sums", err,
           timed(torch, lambda: ss.segment_sums(*sargs), 50),
           timed(torch, lambda: ss.segment_sums_plain(*sargs), 5),
           timed(torch, lambda: zeros.index_add_(0, seg_orig, vals), 50),
           summed * (s * 4 + 8) + n * 8 + n_delta * s * 4, summed * s,
           dict(values=[n, s], segments=n_delta, rows_summed=summed,
                query=query_segment_sums(torch, eng, "thunder")))
    out[-1].update(device_split(torch, lambda: ss.segment_sums(*sargs)))
    out[-1]["library_device_ms"] = device_ms(
        torch, lambda: zeros.index_add_(0, seg_orig, vals))["total"]
    # the trailing pseudo-group of invalid rows, alone: one long segment
    # (the query's masked rows form such a segment, and it is summed)
    inv_vals = vals[~valid].contiguous()
    inv_perm = torch.arange(n_inv, device=dev)
    inv_seg = torch.zeros((n_inv,), dtype=torch.int64, device=dev)
    pargs = (inv_vals, inv_perm, inv_seg, 1)
    if not same_floats(torch, ss.segment_sums(*pargs),
                       ss.segment_sums_plain(*pargs)):
        fail("segment_sums (the pseudo-group alone) differs")
    pseudo = dict(rows=n_inv, ms=timed(
        torch, lambda: ss.segment_sums(*pargs), 20),
        **device_split(torch, lambda: ss.segment_sums(*pargs)))

    # scatter_merge: this batch's delta into the base view (fast path:
    # the batch is already ingested), and a rolled-up view delta whose
    # invalid tail rows are duplicate positions
    d_hi, d_lo = g.group_hi[:n_delta], g.group_lo[:n_delta]
    d_stats = k_out
    base = eng.base
    pos, found = groupby.lookup_rows_in_table(d_hi, d_lo, base.key_hi,
                                              base.key_lo)
    if not bool(found.all()):
        fail("scatter_merge check: delta keys missing from the base view")
    kt = ss.scatter_merge(base.stats.clone(), pos, d_stats)
    pt = ss.scatter_merge_plain(base.stats.clone(), pos, d_stats)
    err = float((kt - pt).abs().max())
    if not same_floats(torch, kt, pt):
        fail(f"scatter_merge differs from its plain version ({err})")
    t = "thunder"
    view = eng.views[t].cuboid
    v_hi, v_lo, v_stats, v_gv = cube_mod.rollup_body(
        eng.codec, eng.views[t].dims, d_hi, d_lo,
        torch.ones((n_delta,), dtype=torch.bool, device=dev), d_stats)
    vpos, _ = groupby.lookup_rows_in_table(v_hi, v_lo, view.key_hi,
                                           view.key_lo)
    dup = int((vpos[1:] == vpos[:-1]).sum())
    if not bool((vpos[1:] >= vpos[:-1]).all()):
        fail("fast-path positions are not non-decreasing")
    kv = ss.scatter_merge(view.stats.clone(), vpos, v_stats.contiguous())
    pv = ss.scatter_merge_plain(view.stats.clone(), vpos,
                                v_stats.contiguous())
    if not same_floats(torch, kv, pv):
        fail("scatter_merge (view delta, duplicate positions) differs")
    err = max(err, float((kv - pv).abs().max()))
    # timed on the view delta: the main path's shape with a long run of
    # duplicate positions (the rolled-up delta's invalid rows)
    v_stats = v_stats.contiguous()
    table = view.stats.clone()
    lib_table = view.stats.clone()
    touched = int(torch.unique(vpos).numel())
    b = vpos.shape[0]
    base_table = base.stats.clone()
    record("scatter_merge", err,
           timed(torch, lambda: ss.scatter_merge(table, vpos, v_stats), 50),
           timed(torch, lambda: ss.scatter_merge_plain(table, vpos, v_stats),
                 5),
           timed(torch, lambda: lib_table.index_add_(0, vpos, v_stats), 50),
           touched * s * 8 + b * 8 + b * s * 4, b * s,
           dict(table=list(view.stats.shape), delta=[b, s],
                duplicates=dup,
                base_delta=[pos.shape[0], s], base_table=list(
                    base.stats.shape),
                base_delta_ms=timed(torch, lambda: ss.scatter_merge(
                    base_table, pos, d_stats), 50),
                base_delta_device_ms=device_ms(torch, lambda: ss.scatter_merge(
                    base_table, pos, d_stats))["total"]))
    out[-1].update(device_split(
        torch, lambda: ss.scatter_merge(table, vpos, v_stats)))
    out[-1]["library_device_ms"] = device_ms(
        torch, lambda: lib_table.index_add_(0, vpos, v_stats))["total"]

    # chunk_sums: estimator stage 1 of a query on the thunder view
    cols5 = [cube_mod.stat_column(tn, k)
             for k in fused_mod.query_stat_names(t)[:5]]
    cvals = view.stats[:, cols5].contiguous()
    cn, cs = cvals.shape
    kp, ktot = ss.chunk_sums(cvals)
    pp, ptot = ss.chunk_sums_plain(cvals)
    err = float((ktot - ptot).abs().max())
    if not (torch.equal(kp, pp) and torch.equal(ktot, ptot)):
        fail(f"chunk_sums differs from its plain version ({err})")
    nb = kp.shape[0]
    padded = torch.zeros((nb * ss.CANONICAL_BLOCK, cs), device=dev)
    padded[:cn] = cvals
    resh = padded.reshape(nb, ss.CANONICAL_BLOCK, cs)
    record("chunk_sums", err,
           timed(torch, lambda: ss.chunk_sums(cvals), 50),
           timed(torch, lambda: ss.chunk_sums_plain(cvals), 5),
           timed(torch, lambda: torch.sum(resh, dim=1), 50),
           cn * cs * 4 + nb * cs * 4 + cs * 4, cn * cs,
           dict(values=[cn, cs], chunks=nb))
    out[-1].update(device_split(torch, lambda: ss.chunk_sums(cvals)))
    one_op("chunk_sums", out[-1])
    out[-1]["library_device_ms"] = device_ms(
        torch, lambda: torch.sum(resh, dim=1))["total"]
    # the wrapper's host cost: Python, checks, the allocation, the views
    # and the ctypes launch, against torch.sum's dispatch
    out[-1]["host_us_per_call"] = host_us(torch,
                                          lambda: ss.chunk_sums(cvals))
    out[-1]["library_host_us_per_call"] = host_us(
        torch, lambda: torch.sum(resh, dim=1))
    out[-1]["host_split_us"] = chunk_sums_host_split(torch, cvals)
    return out, pseudo


def cem_keys_shape(torch, cols, valid, tab) -> dict:
    """The path call ``cem_keys_columns`` on ``cols`` (named columns in
    their own dtypes) bit for bit against its plain version over the
    stacked f32 columns, one device op a call; event-timed and profiled
    beside the route the paths took before (``torch.stack`` of the f32
    conversions, then the matrix form), which must give the same keys; and
    the bound."""
    from repro_torch.kernels import cem_keys as ck
    from repro_torch.kernels.ops import cem_keys_columns
    names = tab.names
    n = valid.shape[0]

    def path():
        return cem_keys_columns(cols, valid, tab)

    def stacked():
        return torch.stack([cols[c].to(torch.float32) for c in names], 1)

    def plain():
        return ck.cem_keys_plain(stacked(), tab.cutpoints, tab.n_cuts,
                                 tab.widths, valid.to(torch.bool))

    def stack_route():
        return ck.cem_keys(stacked(), tab.cutpoints, tab.n_cuts, tab.widths,
                           valid)

    kh, kl = path()
    ph, pl = plain()
    err = float(max((kh - ph).abs().max(), (kl - pl).abs().max()))
    if not (torch.equal(kh, ph) and torch.equal(kl, pl)):
        fail(f"cem_keys at {n} x {len(names)} differs from its plain version "
             f"({err})")
    sh, sl = stack_route()
    if not (torch.equal(sh, ph) and torch.equal(sl, pl)):
        fail(f"cem_keys: the matrix form at {n} x {len(names)} differs")
    split = device_split(torch, path)
    one_op(f"cem_keys_columns at {n} x {len(names)}", split)
    old = device_split(torch, stack_route)
    # the bytes the function needs: each column in its dtype, the mask and
    # the cutpoint table in, two u32 key words per row out; the port holds
    # each word in an int64 tensor, so the kernel writes 16 bytes per row
    needed = (n * sum(cols[c].element_size() for c in names)
              + n * valid.element_size() + tab.cutpoints.numel() * 4 + n * 8)
    compares = n * sum(tab.n_cuts)
    b, by = bound_ms(needed, compares)
    b64, _ = bound_ms(needed + n * 8, compares)
    return dict(rows=n, columns={c: str(cols[c].dtype)[6:] for c in names},
                cutpoints=list(tab.cutpoints.shape), max_abs_err=err,
                ms=timed(torch, path, 50), **split,
                plain_ms=timed(torch, plain, 5), bound_ms=b,
                bound_us=b * 1e3, bound_by=by, bytes_needed=needed,
                bytes_int64_layout=needed + n * 8,
                int64_layout_bound_us=b64 * 1e3, compares=compares,
                stack_route=dict(ms=timed(torch, stack_route, 50),
                                 device_ms=old["device_ms"],
                                 device_by_kernel=old["device_by_kernel"],
                                 device_ops_per_call=old[
                                     "device_ops_per_call"]))


def stream_object_launch(torch, kernel, *args) -> None:
    """``Kernel.launch`` as it was before it read PyTorch's raw hooks (one
    device), kept to time it beside the current one in the same run: the
    current device through ``torch.cuda.current_device()``, a
    ``torch.cuda.Stream`` object built for its handle."""
    from repro_torch.kernels import build
    fn = kernel._fn
    current = torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    code = (fn(*args, build.ticket(current, stream), stream)
            if kernel.ticketed else fn(*args, stream))
    if code != 0:
        fail(f"{kernel.name}: launch failed ({code})")
    kernel.launches += 1


def cem_keys_host_split(torch, cols, valid, tab, rows: int = 4096) -> dict:
    """Host microseconds per call (``host_us``: 1,000 calls, no synchronise
    between them) of the ``cem_keys`` path call and of its steps, on the
    first ``rows`` rows of the batch (so the card never holds the host
    back): the guards (``_launch_words``: the checks and each column's
    pointer, stride and dtype code), the allocation of the key words (two
    tensors, as the wrapper allocates them, and one (2, N) tensor unbound
    into two, the other way), the packing of the launch's words, and
    ``Kernel.launch``, beside its earlier form
    (:func:`stream_object_launch`); then the pieces of a launch: the
    current device and stream each way, the ticket lookup, and the ctypes
    call of a C entry that returns before launching (3 arguments, and the
    9 of ``segment_sums_launch``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import cem_keys as ck
    from repro_torch.kernels.ops import cem_keys_columns
    names = tab.names
    cols = {c: cols[c][:rows] for c in names}
    valid = valid[:rows]
    dev = valid.device
    col_list = [cols[c] for c in names]
    words = ck._launch_words(col_list, valid, tab.cutpoints, tab.n_cuts)
    d = len(names)
    call = ck._CALLS[d]
    keys = torch.empty((2, rows), dtype=torch.int64, device=dev)
    head = (keys.data_ptr(), keys.data_ptr() + 8 * rows,
            tab.cutpoints.data_ptr(), valid.data_ptr(), 1,
            ck.DTYPES[valid.dtype])
    payload = call.pack(*head, rows, d, tab.cutpoints.shape[1], *words)
    empty = call.pack(*head, 0, d, tab.cutpoints.shape[1], *words)
    get_device, raw_stream = build._cuda_hooks()
    index = get_device()
    stream = raw_stream(index)
    seg = build.KERNELS["segment_sums"]._load()
    return dict(
        rows=rows,
        call=host_us(torch, lambda: cem_keys_columns(cols, valid, tab)),
        guards=host_us(torch, lambda: ck._launch_words(
            [cols[c] for c in names], valid, tab.cutpoints, tab.n_cuts)),
        allocation=host_us(torch, lambda: (
            torch.empty(rows, dtype=torch.int64, device=dev),
            torch.empty(rows, dtype=torch.int64, device=dev))),
        allocation_one_unbound=host_us(torch, lambda: torch.empty(
            2, rows, dtype=torch.int64, device=dev).unbind()),
        pack=host_us(torch, lambda: call.pack(
            *head, rows, d, tab.cutpoints.shape[1], *words)),
        launch=host_us(torch, lambda: ck.KERNEL.launch(dev, payload,
                                                       tab.fields)),
        launch_stream_object=host_us(torch, lambda: stream_object_launch(
            torch, ck.KERNEL, payload, tab.fields)),
        launch_pieces=dict(
            current_device=host_us(torch, torch.cuda.current_device),
            current_stream_object=host_us(
                torch, lambda: torch.cuda.current_stream().cuda_stream),
            raw_device=host_us(torch, get_device),
            raw_stream=host_us(torch, lambda: raw_stream(index)),
            ticket=host_us(torch, lambda: build.ticket(index, stream)),
            ctypes_3_args_no_launch=host_us(
                torch, lambda: ck.KERNEL._fn(empty, tab.fields, stream)),
            ctypes_9_args_no_launch=host_us(
                torch, lambda: seg(0, 0, 0, 0, 0, 0, 0, 0, stream))))


def chunk_sums_host_split(torch, vals) -> dict:
    """Host microseconds per call of each step of the ``chunk_sums``
    wrapper on ``vals`` (``host_us``: 1,000 calls each, no synchronise
    between them): its guards, its allocation, its two views, and
    ``Kernel.launch`` (the current device and stream, the ticket lookup,
    the ctypes call, the error check and the count)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import segment_stats as ss
    n, s = vals.shape
    nb = ss._n_chunks(n)
    dev = vals.device
    buf = torch.empty((nb + 1, s), dtype=torch.float32, device=dev)

    def guards():
        build.require_cuda("chunk_sums", vals)
        build.check("chunk_sums values", vals, torch.float32, (n, s))
        ss._n_chunks(n)

    return dict(
        guards=host_us(torch, guards),
        allocation=host_us(torch, lambda: torch.empty(
            (nb + 1, s), dtype=torch.float32, device=dev)),
        views=host_us(torch, lambda: (buf[:nb], buf[nb])),
        launch=host_us(torch, lambda: ss.CHUNK_SUMS.launch(
            dev, vals.data_ptr(), buf.data_ptr(), n, s, nb)),
        launch_stream_object=host_us(torch, lambda: stream_object_launch(
            torch, ss.CHUNK_SUMS, vals.data_ptr(), buf.data_ptr(), n, s, nb)))


def chunk_sums_standardisation(torch, table) -> dict:
    """``chunk_sums`` at the propensity standardisation's shape
    (``core/propensity.py::_standardize``: the valid mask and the masked
    features of PROPENSITY over the whole relation, 2^22 x 4): bit for bit
    its plain version, timed by CUDA events and by the profiler (one
    device op a call), beside ``torch.sum`` over the zero-padded reshape
    and the bound."""
    from repro_torch.kernels import segment_stats as ss
    _, features = PROPENSITY
    X = torch.stack([table[f].to(torch.float32) for f in features], -1)
    w = table.valid.to(torch.float32)[:, None]
    vals = torch.cat([w, X * w], dim=1).contiguous()
    n, s = vals.shape
    kp, kt = ss.chunk_sums(vals)
    pp, pt = ss.chunk_sums_plain(vals)
    if not (same_floats(torch, kp, pp) and same_floats(torch, kt, pt)):
        fail("chunk_sums differs from its plain version at the "
             "standardisation's shape")
    nb = kp.shape[0]
    padded = torch.zeros((nb * ss.CANONICAL_BLOCK, s), device=vals.device)
    padded[:n] = vals
    resh = padded.reshape(nb, ss.CANONICAL_BLOCK, s)
    b, by = bound_ms(n * s * 4 + nb * s * 4 + s * 4, n * s)
    split = device_split(torch, lambda: ss.chunk_sums(vals))
    one_op("chunk_sums (standardisation)", split)
    return dict(values=[n, s], chunks=nb,
                ms=timed(torch, lambda: ss.chunk_sums(vals), 50), **split,
                library_ms=timed(torch, lambda: torch.sum(resh, dim=1), 50),
                library_device_ms=device_ms(
                    torch, lambda: torch.sum(resh, dim=1))["total"],
                bound_ms=b, bound_us=b * 1e3, bound_by=by)


def query_segment_sums(torch, eng, treatment) -> dict:
    """``segment_sums`` at the shape of one uncached ``ate()``: the
    canonical re-sort of ``_estimate_from_roles`` over the view's C slots
    for airport 0 (four of a step's five queries per treatment are
    airport subpopulations), its C x 6 role stats with the masked slots'
    run (zeros) summed too; bit for bit its plain version, timed by CUDA
    events and by the profiler."""
    from repro_torch.core import cube as cube_mod
    from repro_torch.core import fused as fused_mod
    from repro_torch.core import groupby
    from repro_torch.core.keys import INVALID_HI, INVALID_LO
    from repro_torch.kernels import segment_stats as ss
    cub, keep = eng.views[treatment].cuboid, eng.views[treatment].keep
    cols = [cube_mod.stat_column(eng._tnames, k)
            for k in fused_mod.query_stat_names(treatment)]
    m = fused_mod._query_mask(cub.key_hi, cub.key_lo, cub.group_valid, keep,
                              cub.codec, (("airport", (0,)),))
    g = groupby.group_by_key(torch.where(m, cub.key_hi, INVALID_HI),
                             torch.where(m, cub.key_lo, INVALID_LO))
    vals = torch.where(m[:, None], cub.stats[:, cols], 0.0).contiguous()
    args = (vals, g.perm, g.seg_ids, g.nrows)
    if not same_floats(torch, ss.segment_sums(*args),
                       ss.segment_sums_plain(*args)):
        fail("segment_sums (query shape) differs from its plain version")
    return dict(values=list(vals.shape), masked_rows=int((~m).sum()),
                ms=timed(torch, lambda: ss.segment_sums(*args), 50),
                **device_split(torch, lambda: ss.segment_sums(*args)))


def offline_segment_sums(torch, sub, table) -> dict:
    """``segment_sums`` at the offline path's shapes: the subclass groups'
    stat sums as ``cem_from_keys`` takes them (the 2^22 rows, four columns,
    one segment id per row: five subclasses and the trimmed rows'
    pseudo-group), and the call's longest run alone; bit for bit the
    plain version, timed by CUDA events and the profiler."""
    from repro_torch.kernels import segment_stats as ss
    g = sub.groups.grouping
    # the rows cem_from_keys sums: valid, propensity inside the trim
    lo, hi = SUBCLASS_TRIM
    w = (table.valid & (sub.ps >= lo) & (sub.ps <= hi)).to(torch.float32)
    t = table[OFFLINE_T].to(torch.float32) * w
    c = (1.0 - table[OFFLINE_T].to(torch.float32)) * w
    y = table[OFFLINE_Y].to(torch.float32)
    vals = torch.stack([t, c, t * y, c * y], dim=1).contiguous()
    # the call's runs: the subclasses and the trimmed rows' pseudo-group
    rows = torch.bincount(g.seg_ids)
    n_run = int(rows.max())
    run_args = (vals[:n_run].contiguous(),
                torch.arange(n_run, device=vals.device),
                torch.zeros((n_run,), dtype=torch.int64, device=vals.device),
                1)
    out = {}
    for name, args in (("subclass_call", (vals, g.perm, g.seg_ids, g.nrows)),
                       ("one_run", run_args)):
        if not same_floats(torch, ss.segment_sums(*args),
                           ss.segment_sums_plain(*args)):
            fail(f"segment_sums (offline {name}) differs from its plain "
                 "version")
        out[name] = dict(
            values=list(args[0].shape), segments=args[3],
            ms=timed(torch, lambda: ss.segment_sums(*args), 10),
            device_ms=device_ms(torch, lambda: ss.segment_sums(*args),
                                reps=5)["total"])
    out["run_rows"] = rows[rows > 0].tolist()
    return out


def parts_kernel_check(torch, eng, batch, counts) -> dict:
    """``scatter_merge_parts`` against its plain version at the shapes the
    partitioned retraction gave it: ``batch``'s delta (sign-flipped),
    rolled up to the ``thunder`` view, routed to the engine's partitions
    and looked up in them — the fast path's input (the batch is
    ingested)."""
    from repro_torch.core import cube as cube_mod
    from repro_torch.core import groupby
    from repro_torch.kernels import segment_stats as ss

    cols = {c: batch.columns[c] for c in eng._row_cols}
    d_hi, d_lo, sums = cube_mod.delta_build_body(
        cols, batch.valid, cutpoints=eng._cutpoints, treatments=eng._tnames,
        outcome=eng.outcome, read_count=lambda n: int(n))
    d_gv = torch.ones((d_hi.shape[0],), dtype=torch.bool, device=eng.device)
    t = "thunder"
    view = eng.views[t].cuboid
    v_hi, v_lo, v_stats, v_gv = cube_mod.route_delta(
        *cube_mod.rollup_body(eng.codec, eng.views[t].dims, d_hi, d_lo, d_gv,
                              -sums), eng.n_parts)
    pos, found = groupby.lookup_rows_in_table(v_hi, v_lo, view.key_hi,
                                              view.key_lo)
    if not bool((found | ~v_gv).all()):
        fail("scatter_merge_parts check: delta keys missing from the view")
    if not bool((pos[:, 1:] >= pos[:, :-1]).all()):
        fail("partitioned fast-path positions decrease within a partition")
    vals = v_stats.contiguous()
    kt = ss.scatter_merge_parts(view.stats.clone(), pos, vals)
    pt = ss.scatter_merge_parts_plain(view.stats.clone(), pos, vals)
    err = float((kt - pt).abs().max())
    if not same_floats(torch, kt, pt):
        fail(f"scatter_merge_parts differs from its plain version ({err})")
    p, c, s = view.stats.shape
    b = pos.shape[1]
    slots = (pos + c * torch.arange(p, device=eng.device)[:, None]).reshape(-1)
    touched = int(torch.unique(slots).numel())
    table, lib_table = view.stats.clone(), view.stats.clone().view(p * c, s)
    flat_vals = vals.reshape(p * b, s)
    # bytes as for scatter_merge: each touched cell read and written, each
    # row's position and delta stats read once; one add per element
    n_rows = p * b
    bound, by = bound_ms(touched * s * 8 + n_rows * 8 + n_rows * s * 4,
                         n_rows * s)
    src, rep = KERNEL_FILES["scatter_merge_parts"]
    return dict(
        name="scatter_merge_parts", route="cuda", source=src, replaces=rep,
        launches=counts["scatter_merge_parts"], max_abs_err=err,
        ms=timed(torch, lambda: ss.scatter_merge_parts(table, pos, vals), 50),
        **device_split(
            torch, lambda: ss.scatter_merge_parts(table, pos, vals)),
        plain_ms=timed(torch, lambda: ss.scatter_merge_parts_plain(
            table, pos, vals), 5),
        bound_ms=bound, bound_us=bound * 1e3, bound_by=by,
        library_ms=timed(torch, lambda: lib_table.index_add_(
            0, slots, flat_vals), 50),
        library="index_add_ on the flattened (P*C, S) table at p*C + pos",
        shapes=dict(tables=[p, c, s], delta=[p, b, s],
                    valid_rows=int(v_gv.sum()), touched_slots=touched))


def design(torch, X, model):
    """The Newton terms' inputs as ``fit_logistic`` builds them: X
    standardized by the model's (mean, std), with the bias column."""
    Xs = (X - model.mean) / model.std
    ones = torch.ones((X.shape[0], 1), dtype=torch.float32, device=X.device)
    return torch.cat([Xs, ones], dim=1).contiguous()


def newton_check(torch, Xb, t, m, w):
    """``logistic_newton_terms`` against its plain version at one shape:
    rel RTOL_NEWTON, two kernel runs bitwise equal. Returns the timings,
    the error and the bound."""
    from repro_torch.kernels import logistic_grad as lg
    args = (Xb, t.to(torch.float32).contiguous(),
            m.to(torch.float32).contiguous(), w.contiguous())
    g, H = lg.logistic_newton_terms(*args)
    g2, H2 = lg.logistic_newton_terms(*args)
    if not (torch.equal(g, g2) and torch.equal(H, H2)):
        fail("logistic_newton_terms: two runs differ")
    pg, pH = lg.logistic_newton_terms_plain(*args)
    err = 0.0
    for a, b in ((g, pg), (H, pH)):
        e = float((a - b).abs().max())
        err = max(err, e)
        if e > RTOL_NEWTON * float(b.abs().max()):
            fail(f"logistic_newton_terms differs from its plain version "
                 f"({e}) at {tuple(Xb.shape)}")
    X, tt, mm, ww = args

    def library():
        p = torch.sigmoid(X @ ww)
        return X.t() @ (mm * (p - tt)), (X * (mm * p * (1 - p))[:, None]
                                         ).t() @ X

    n, d = X.shape
    # bytes: X, t and m read once, g and H written once. Operations per
    # row: the logit (2d), p, r and s (7, exp counted as one), the g terms
    # (2d) and the H terms (3 per upper-triangle entry)
    n_bytes = n * (4 * d + 8) + (d + d * d) * 4
    n_ops = n * (4 * d + 7 + 3 * d * (d + 1) // 2)
    b, by = bound_ms(n_bytes, n_ops)
    split = device_split(torch, lambda: lg.logistic_newton_terms(*args))
    one_op(f"logistic_newton_terms at {tuple(X.shape)}", split)
    return dict(
        err=err, ms=timed(torch, lambda: lg.logistic_newton_terms(*args), 50),
        **split,
        plain_ms=timed(torch, lambda: lg.logistic_newton_terms_plain(*args),
                       5),
        library_ms=timed(torch, library, 50),
        library_device_ms=device_ms(torch, library)["total"],
        n_bytes=n_bytes, n_ops=n_ops, bound_ms=b, bound_by=by, shape=[n, d])


def newton_checks(torch, eng, table, full_model, counts) -> dict:
    """The Newton-terms kernel at the main path's two shapes: the
    reservoir under the engine's last model, and the whole relation under
    the full-table model."""
    treatment, features = PROPENSITY
    cols, rvalid = eng.stream.reservoir()
    model = eng.models[treatment]
    res = newton_check(torch, design(torch, torch.stack(
        [cols[f] for f in features], -1), model), cols[treatment], rvalid,
        model.w)
    X = torch.stack([table[f].to(torch.float32) for f in features], -1)
    full = newton_check(torch, design(torch, X, full_model),
                        table[treatment], table.valid, full_model.w)
    src, rep = KERNEL_FILES["logistic_newton_terms"]
    return dict(
        name="logistic_newton_terms", route="cuda", source=src,
        replaces=rep, launches=counts["logistic_newton_terms"],
        max_abs_err=max(res["err"], full["err"]), ms=full["ms"],
        device_ms=full["device_ms"],
        device_by_kernel=full["device_by_kernel"],
        device_ops_per_call=full["device_ops_per_call"],
        plain_ms=full["plain_ms"],
        bound_ms=full["bound_ms"],
        bound_us=full["bound_ms"] * 1e3, bound_by=full["bound_by"],
        library_ms=full["library_ms"],
        library="torch.sigmoid(X @ w), X.T @ r, (X * s).T @ X: three "
                "library calls (with their elementwise ops)",
        library_device_ms=full["library_device_ms"],
        shapes=dict(X=full["shape"], reservoir=res,
                    note="ms (CUDA events around the wrapper call), "
                         "device_ms (profiler, by kernel), plain_ms and "
                         "the bound are the 2^22-row call "
                         "(propensity_scores); reservoir: "
                         "refresh_propensity"))


def propensity_repeats(torch, eng, table) -> dict:
    """Steady-state times of the propensity path (its first calls on the
    main path include one-time costs: CUDA's lazy module loading and the
    cuBLAS / cuSOLVER handles): a cold and a warm fit over the reservoir,
    as ``refresh_propensity`` runs them, and ``propensity_scores`` over
    the whole relation, each the median of 3 host-clocked runs ending in
    a synchronise; then one warm fit under the profiler."""
    from repro_torch.core.propensity import fit_logistic, propensity_scores
    treatment, features = PROPENSITY
    cols, rvalid = eng.stream.reservoir()
    X = torch.stack([cols[f] for f in features], -1)
    moments = eng.stream.moments(features)
    model = eng.models[treatment]

    def clocked(fn):
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(runs)

    def warm():
        fit_logistic(X, cols[treatment], rvalid, n_iter=4, init=model)

    warm_dev = device_ms(torch, warm, reps=5)
    return dict(
        cold_fit_ms=clocked(lambda: fit_logistic(
            X, cols[treatment], rvalid, n_iter=32, moments=moments)),
        warm_fit_ms=clocked(warm),
        scores_ms=clocked(lambda: propensity_scores(table, treatment,
                                                    list(features))),
        warm_fit_device_ms=warm_dev["total"],
        warm_fit_top=dict(sorted(warm_dev["by_kernel"].items(),
                                 key=lambda kv: -kv[1])[:8]))


def profile_window(torch, eng, batch, treatments) -> dict:
    """One steady-state window under ``torch.profiler``: a retraction and
    re-ingest of an ingested batch, then every query of a step (all
    uncached). Returns the device-busy share of the window and the ops
    that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.ingest(batch, retract=True)
        eng.ingest(batch)
        for t in sorted(treatments):
            for sub in (None, *AIRPORTS):
                eng.ate(t, None if sub is None else {"airport": [sub]})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # device-side events only (kernels, copies, memsets): the host ops
    # that launched them carry the same time again as "self device time"
    from torch.autograd import DeviceType
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    return dict(window="retract + re-ingest of one batch, 15 queries",
                wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms if wall_ms else None,
                top=[dict(op=k, device_ms=us / 1e3, calls=c)
                     for k, us, c in rows[:15] if us > 0])


# ----------------------------------------------------------- offline path
def table3_specs(CoarsenSpec):
    """The CEM specs of the paper's Table 3 (bench_quality.py:77-82)."""
    return {
        "airport": CoarsenSpec.categorical(16),
        "traffic": CoarsenSpec.equal_width(0, 40, 8),
        "w_tempm": CoarsenSpec.equal_width(-20, 40, 5),
        "w_wspdm": CoarsenSpec.equal_width(0, 80, 5),
    }


class Clock:
    """Host-clocked calls, each ended by a synchronise on the card."""

    def __init__(self, torch, device):
        self.sync = (torch.cuda.synchronize if device.type == "cuda"
                     else (lambda: None))
        self.ms = {}

    def __call__(self, name, fn):
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        self.ms[name] = (time.perf_counter() - t0) * 1e3
        return out


def offline_relation(torch, table, ps=None):
    """The offline path's first part, on the whole relation and on the
    table's device: CEM with the Table 3 specs and EM on airport and
    carrier (each with ``estimate_ate`` and its variance), the difference
    in means, the raw imbalance, ``propensity_scores``, NNMWR on the
    propensity distance with its ATT, subclassification, and AWMD of the
    Table 3 covariates. ``ps`` replaces the fitted scores downstream of
    the fit (the CPU run gets the card's). Returns (results, clock)."""
    from repro_torch.core import (CoarsenSpec, awmd, cem,
                                  difference_in_means, estimate_ate,
                                  exact_matching, nnmwr, nnmwr_att,
                                  ps_distance_features, raw_imbalance,
                                  subclassify)
    from repro_torch.core.propensity import propensity_scores
    clock = Clock(torch, table.device)
    t, y, v = table[OFFLINE_T], table[OFFLINE_Y], table.valid
    covs = {c: table[c] for c in BALANCE_COVS}
    r = {}
    for name, fn in (
            ("cem", lambda: cem(table, OFFLINE_T, OFFLINE_Y,
                                table3_specs(CoarsenSpec))),
            ("em", lambda: exact_matching(table, OFFLINE_T, OFFLINE_Y,
                                          EM_COVS))):
        res = r[name] = clock(name, fn)
        r[f"{name}_est"] = clock(f"{name}_estimate_ate", lambda: estimate_ate(
            res.groups, y, t, res.table.valid))
        r[f"{name}_awmd"] = clock(f"{name}_awmd", lambda: awmd(
            res.groups, covs, t, res.table.valid))
    r["dim"] = clock("difference_in_means",
                     lambda: difference_in_means(y, t, v))
    r["raw"] = clock("raw_imbalance", lambda: raw_imbalance(covs, t, v))
    r["fitted_ps"], r["model"] = clock("propensity_scores", lambda: (
        propensity_scores(table, OFFLINE_T, list(PS_FEATURES))))
    ps = r["ps"] = r["fitted_ps"] if ps is None else ps
    r["nnmwr_ps"] = clock("nnmwr_ps", lambda: nnmwr(
        ps_distance_features(ps), t, v, k=1, caliper=PS_CALIPER,
        engine="sorted1d"))
    r["nnmwr_ps_att"] = clock("nnmwr_att", lambda: nnmwr_att(
        y, r["nnmwr_ps"]))
    sub = r["sub"] = clock("subclassify", lambda: subclassify(
        table, OFFLINE_T, OFFLINE_Y, ps, n_subclasses=5, trim=SUBCLASS_TRIM))
    r["sub_est"] = clock("sub_estimate_ate", lambda: estimate_ate(
        sub.groups, y, t, sub.table.valid))
    r["sub_awmd"] = clock("sub_awmd", lambda: awmd(
        sub.groups, covs, t, sub.table.valid))
    return r, clock


def offline_matching(torch, table, ps, n_rows, U=None):
    """The offline path's second part, on rows [0, n_rows): the
    Mahalanobis rotation of the five propensity features, NNMWR (k = 1)
    and NNMNR (k = 1, m = 8) on the quadratic engine, and NNMNR on the
    propensity distance. ``U`` replaces the rotation (the comparison runs
    get the card's rotated features). Returns (results, clock)."""
    from repro_torch.core import (features, mahalanobis_transform, nnmnr,
                                  nnmwr, ps_distance_features)
    clock = Clock(torch, table.device)
    rows = table.slice(0, n_rows)
    t, v = rows[OFFLINE_T], rows.valid
    if U is None:
        U = clock("mahalanobis_transform", lambda: mahalanobis_transform(
            features(rows, PS_FEATURES), v))
    r = {"U": U}
    r["nnmwr_mahalanobis"] = clock("nnmwr_mahalanobis", lambda: nnmwr(
        U, t, v, k=1, caliper=MAHALANOBIS_CALIPER, engine="quadratic"))
    r["nnmnr_mahalanobis"] = clock("nnmnr_mahalanobis", lambda: nnmnr(
        U, t, v, k=1, caliper=MAHALANOBIS_CALIPER, m_candidates=8))
    r["nnmnr_ps"] = clock("nnmnr_ps", lambda: nnmnr(
        ps_distance_features(ps[:n_rows]), t, v, k=1, caliper=PS_CALIPER))
    return r, clock


def sample_extras(torch, table, U, n_rows) -> dict:
    """Calls that make the card-against-CPU comparison of the sample
    strict whatever the caliper leaves: the raw k-NN (d2, idx) at k = 8,
    and NNMNR at a caliper that every candidate passes (WIDE_CALIPER)."""
    from repro_torch.core import nnmnr
    from repro_torch.kernels.knn_topk import knn_topk
    rows = table.slice(0, n_rows)
    t, v = rows[OFFLINE_T], rows.valid
    c_valid = (~t.to(torch.bool) & v).contiguous()
    d2, idx = knn_topk(U, U, c_valid, 8)
    return dict(d2=d2, idx=idx, nnmnr_wide=nnmnr(
        U, t, v, k=1, caliper=WIDE_CALIPER, m_candidates=8))


def path_wide_nnmnr(torch, rows, U):
    """NNMNR (k = 1, m = 8) on the path's rotated rows at WIDE_CALIPER:
    edges on which the sweep takes a control for most treated rows. Run
    after the path's launch counts are read; used only to hold the sweep
    against its plain version."""
    from repro_torch.core import nnmnr
    return nnmnr(U, rows[OFFLINE_T], rows.valid, k=1, caliper=WIDE_CALIPER,
                 m_candidates=8)


def match_summary(torch, y, res) -> dict:
    """Matched treated units, distinct matched controls and the ATT of a
    k-NN match (the ATT formula of ``nnmwr_att`` over its pairs)."""
    from repro_torch.core import nnmwr_att
    return dict(treated=int(res.n_matched_treated()),
                controls=int(torch.unique(res.idx[res.ok]).numel()),
                att=float(nnmwr_att(y, res)))


def estimate_summary(est) -> dict:
    return {f: float(getattr(est, f)) for f in (
        "ate", "att", "variance", "n_matched_treated", "n_matched_control",
        "n_groups")}


class Diff:
    """Card results held against CPU results: exact fields must be equal
    (floats bit for bit); tolerated fields within their rtol. Keeps the
    largest relative difference and whether every field was bitwise."""

    def __init__(self, torch, np):
        self.torch, self.np = torch, np
        self.max_rel, self.bitwise, self.n_exact = 0.0, True, 0

    def exact(self, label, a, b):
        a, b = self.np.asarray(a.cpu()), self.np.asarray(b.cpu())
        if a.dtype.kind == "f":
            a, b = a.view(self.np.uint32), b.view(self.np.uint32)
        if a.shape != b.shape or not self.np.array_equal(a, b):
            fail(f"offline: {label} differs between cuda and cpu")
        self.n_exact += 1

    def close(self, label, a, b, rtol):
        a, b = float(a), float(b)
        if not self.np.isfinite(a):
            fail(f"offline: {label} is not finite ({a})")
        rel = abs(a - b) / max(abs(b), 1e-6)
        self.max_rel = max(self.max_rel, rel)
        self.bitwise &= a == b
        if rel > rtol:
            fail(f"offline: {label} {a} vs {b} beyond rtol {rtol}")

    def groups(self, label, g, c):
        for f in ("keep", "n_treated", "n_control"):
            self.exact(f"{label} {f}", getattr(g, f), getattr(c, f))
        for f in ("sum_y_t", "sum_y_c"):
            a, b = getattr(g, f).cpu(), getattr(c, f)
            if not self.np.allclose(a, b, rtol=RTOL_SUMS, atol=1e-3):
                fail(f"offline: {label} {f} beyond rtol {RTOL_SUMS}")
            self.bitwise &= bool(self.torch.equal(a, b))

    def estimate(self, label, g, c):
        for f in ("n_matched_treated", "n_matched_control", "n_groups"):
            if float(getattr(g, f)) != float(getattr(c, f)):
                fail(f"offline: {label} {f} differs")
        for f, tol in (("ate", RTOL_EST), ("att", RTOL_EST),
                       ("variance", RTOL_VAR)):
            self.close(f"{label} {f}", getattr(g, f), getattr(c, f), tol)

    def match(self, label, g, c):
        for f in ("idx", "dist", "ok", "treated_mask"):
            self.exact(f"{label} {f}", getattr(g, f), getattr(c, f))


def compare_offline(torch, np, g, c, mg, mc, xg, xc, y_g, y_c) -> dict:
    """The offline path on the card against the port's CPU run: part 1
    over the whole relation (the CPU given the card's scores), part 2 and
    :func:`sample_extras` on the first CPU_MATCH_ROWS rows (both given the
    card's rotation)."""
    diff = Diff(torch, np)
    diff.exact("sample knn d2", xg["d2"], xc["d2"])
    diff.exact("sample knn idx", xg["idx"], xc["idx"])
    diff.match("sample nnmnr (wide caliper)", xg["nnmnr_wide"],
               xc["nnmnr_wide"])
    for name in ("cem", "em", "sub"):
        gr, cr = g[name], c[name]
        diff.exact(f"{name} matched mask", gr.table.valid, cr.table.valid)
        diff.exact(f"{name} subclass", gr.table["subclass"],
                   cr.table["subclass"])
        diff.groups(name, gr.groups, cr.groups)
        diff.estimate(name, g[f"{name}_est"], c[f"{name}_est"])
        for cov in BALANCE_COVS:
            diff.close(f"{name} awmd {cov}", g[f"{name}_awmd"][cov],
                       c[f"{name}_awmd"][cov], RTOL_EST)
    for name in ("cem", "em"):
        diff.exact(f"{name} key_hi", g[name].key_hi, c[name].key_hi)
        diff.exact(f"{name} key_lo", g[name].key_lo, c[name].key_lo)
    diff.close("difference_in_means", g["dim"], c["dim"], RTOL_EST)
    for cov in BALANCE_COVS:
        diff.close(f"raw imbalance {cov}", g["raw"][cov], c["raw"][cov],
                   RTOL_EST)
    diff.match("nnmwr_ps", g["nnmwr_ps"], c["nnmwr_ps"])
    diff.close("nnmwr_ps att", g["nnmwr_ps_att"], c["nnmwr_ps_att"],
               RTOL_EST)
    model_rel = compare_models(np, "offline propensity_scores",
                               host_model(g["model"]), host_model(c["model"]))
    ps_diff = float((g["fitted_ps"].cpu() - c["fitted_ps"]).abs().max())
    if ps_diff > RTOL_MODEL:
        fail(f"offline propensity scores differ by {ps_diff}")
    for name in ("nnmwr_mahalanobis", "nnmnr_mahalanobis", "nnmnr_ps"):
        diff.match(f"{name} ({CPU_MATCH_ROWS} rows)", mg[name], mc[name])
        diff.close(f"{name} att", match_summary(torch, y_g, mg[name])["att"],
                   match_summary(torch, y_c, mc[name])["att"], RTOL_EST)
    return dict(exact_fields=diff.n_exact, bitwise=diff.bitwise,
                max_rel_estimate_diff=diff.max_rel, model_max_rel=model_rel,
                scores_max_abs_diff=ps_diff, match_rows=CPU_MATCH_ROWS,
                sample_matched=int(xg["nnmnr_wide"].ok.sum()),
                sample_within_caliper=int(mg["nnmnr_mahalanobis"].ok.sum()))


def knn_kernel_check(torch, U, c_valid, counts) -> dict:
    """``knn_topk`` against its plain version on the card, bit for bit, on
    the first KNN_SLAB rows of the rotated sample against all its rows as
    controls, at k = 1 and k = 8; timed there beside the plain version and
    ``torch.cdist(Q, C).topk(k)`` (two library calls, another tie order: a
    yardstick only), and at the path's shape (every row a query)."""
    from repro_torch.kernels import knn_topk as tk
    C = U.contiguous()
    Q = C[:KNN_SLAB].contiguous()
    cv = c_valid.contiguous()
    err, idx_differ, big_differ, filled = 0.0, 0, 0, 0
    for k in (1, 8):
        kd, ki = tk.knn_topk(Q, C, cv, k)
        pd, pi = tk.knn_topk_plain(Q, C, cv, k)
        # |kernel - plain| over the slots that both fill (d2 below BIG);
        # slots that only one fills, and differing indices, counted apart
        kf, pf = kd < tk.BIG, pd < tk.BIG
        both = kf & pf
        filled += int(both.sum())
        if bool(both.any()):
            err = max(err, float((kd[both].double() - pd[both].double())
                                 .abs().max()))
        big_differ += int((kf != pf).sum())
        idx_differ += int((ki != pi).sum())
        if not (torch.equal(kd.view(torch.int32), pd.view(torch.int32))
                and torch.equal(ki, pi)):
            fail(f"knn_topk differs from its plain version at k={k} "
                 f"(max |d2 diff| {err}, {idx_differ} indices, "
                 f"{big_differ} BIG slots)")
    nq, d = Q.shape
    nc = C.shape[0]
    k = 8

    def bound(n_q):
        # inputs read once, (d2, idx) written once; 2d + 3 f32 operations
        # per (query, valid control) pair: the dot product, the norms'
        # sum, the subtraction and the clamp
        n_valid = int(cv.sum())
        return bound_ms((n_q + nc) * d * 4 + nc + n_q * k * 12,
                        n_q * n_valid * (2 * d + 3))

    b, by = bound(nq)
    path_b, _ = bound(nc)
    src, rep = KERNEL_FILES["knn_topk"]
    index = torch.cuda.current_device()
    launch = {}
    for label, n_q, kk in (("slab_k8", nq, 8), ("path_k1", nc, 1),
                           ("path_k8", nc, 8)):
        slots = tk.resident_blocks(index, kk, d)
        r, qblocks, n_ranges, span = tk.plan(n_q, nc, kk, d, slots)
        launch[label] = dict(R=r, resident_blocks=slots,
                             query_blocks=qblocks, S=n_ranges,
                             controls_per_range=span,
                             blocks=qblocks * n_ranges,
                             merge_blocks=(-(-n_q // tk.THREADS)
                                           if n_ranges > 1 else 0))
    print(json.dumps({"knn_topk_launch": dict(
        sms=tk.sm_count(index), **launch)}))
    return dict(
        name="knn_topk", route="cuda", source=src, replaces=rep,
        launches=counts["knn_topk"], max_abs_err=err,
        ms=timed(torch, lambda: tk.knn_topk(Q, C, cv, k), 10),
        plain_ms=timed(torch, lambda: tk.knn_topk_plain(Q, C, cv, k), 2,
                       warmup=1),
        bound_ms=b, bound_us=b * 1e3, bound_by=by,
        library_ms=timed(torch, lambda: torch.cdist(Q, C).topk(
            k, dim=1, largest=False), 5, warmup=1),
        library="torch.cdist(Q, C).topk(8, largest=False): two library "
                "calls, another tie order",
        shapes=dict(
            Q=[nq, d], C=[nc, d], k=k, valid_controls=int(cv.sum()),
            compared=dict(k=[1, 8], filled_slots=filled,
                          indices_differing=idx_differ,
                          big_slots_differing=big_differ),
            path_ms={f"k{kk}": timed(torch, lambda: tk.knn_topk(
                C, C, cv, kk), 2, warmup=1) for kk in (1, 8)},
            path_library_ms={f"k{kk}": timed(torch, lambda: [
                torch.cdist(C[q:q + KNN_SLAB], C).topk(
                    kk, dim=1, largest=False)
                for q in range(0, nc, KNN_SLAB)], 1, warmup=1)
                for kk in (1, 8)},
            path_bound_ms=path_b, launch=launch,
            note="ms, plain_ms, bound_ms and library_ms are the "
                 f"{nq} x {nc} slab at k = 8; path_ms the path's "
                 f"{nc} x {nc} calls (NNMWR k = 1, NNMNR's candidates "
                 "k = 8); path_library_ms cdist + topk over the path's "
                 f"{nc // KNN_SLAB} slabs of {KNN_SLAB} queries, summed "
                 "(the whole distance matrix does not fit)"))


def sweep_edges(torch, res, every_row=False):
    """The sorted candidate edges ``greedy_nnmnr`` swept for an NNMNR
    result (its with-replacement ``ok`` is ``dist < BIG`` on treated
    rows); with ``every_row``, the same candidates with every row taken as
    treated (the dense shape: every filled slot an edge below BIG)."""
    from repro_torch.kernels.knn_topk import BIG
    ok = res.dist < BIG
    if not every_row:
        ok = ok & res.treated_mask[:, None]
    d = torch.where(ok, res.dist, BIG).reshape(-1)
    n, m = res.idx.shape
    order = torch.sort(d, stable=True).indices
    t = torch.arange(n, device=d.device).repeat_interleave(m)
    return (d[order].contiguous(), res.idx.reshape(-1)[order].contiguous(),
            t[order].contiguous(), n)


def sweep_one_thread(torch, d, c, t, n_rows: int, k: int):
    """The one-thread kernel that ``greedy_sweep``'s kernels replaced
    (``greedy_sweep_serial_launch`` in the same source; the same contract),
    the yardstick the redesign is timed against. Its calls count no
    launch."""
    import ctypes
    from repro_torch.kernels import greedy_sweep as gs
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    taken = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
    used_c = torch.zeros((n_rows,), dtype=torch.uint8, device=d.device)
    cnt_t = torch.zeros((n_rows,), dtype=torch.int32, device=d.device)
    fn = gs.KERNEL.function("greedy_sweep_serial_launch",
                            [p, p, p, i64, i64, i32, p, p, p, p])
    code = fn(d.data_ptr(), c.data_ptr(), t.data_ptr(), d.shape[0], n_rows,
              k, used_c.data_ptr(), cnt_t.data_ptr(), taken.data_ptr(),
              torch.cuda.current_stream(d.device).cuda_stream)
    if code != 0:
        fail(f"greedy_sweep_serial_launch: error {code}")
    return taken


def sweep_kernel_check(torch, small, full, wide, counts) -> dict:
    """``greedy_sweep`` against its plain version on the card, bit for
    bit, on the CPU_MATCH_ROWS sample's edges (its wide-caliper NNMNR's),
    on the path's (the 2^17-row Mahalanobis NNMNR's, caliper 0.5), on the
    same rows' edges at WIDE_CALIPER, where most treated rows take a
    control, and on the dense shape (those candidates with every row
    treated: every edge below BIG); timed on the path's, the wide and the
    dense edges, beside the one-thread kernel it replaced on the path's
    and the dense edges (in turns: old, new, new, old). No library call
    computes it."""
    from repro_torch.kernels import greedy_sweep as gs
    from repro_torch.kernels.knn_topk import BIG
    err, differ, taken, below = 0.0, {}, {}, {}
    sets = {"sample": sweep_edges(torch, small),
            "path": sweep_edges(torch, full),
            "path_wide": sweep_edges(torch, wide),
            "dense": sweep_edges(torch, wide, every_row=True)}
    for label, args in sets.items():
        kf = gs.greedy_sweep(*args, 1)
        pf = gs.greedy_sweep_plain(*args, 1)
        diff = (kf.to(torch.int32) - pf.to(torch.int32)).abs()
        differ[label] = int(diff.sum())
        taken[label] = int(kf.sum())
        below[label] = int((args[0] < BIG).sum())
        if diff.numel():
            err = max(err, float(diff.max()))
        if not torch.equal(kf, pf):
            fail(f"greedy_sweep differs from its plain version ({label}: "
                 f"{differ[label]} flags)")
    print(json.dumps({"greedy_sweep_edges": dict(below_big=below,
                                                  taken=taken)}))
    d, c, t, n = sets["path"]
    e = d.shape[0]

    def in_turns(args):
        old = [timed(torch, lambda: sweep_one_thread(torch, *args, 1), 2,
                     warmup=1)]
        new = [timed(torch, lambda: gs.greedy_sweep(*args, 1), 10)
               for _ in range(2)]
        old.append(timed(torch, lambda: sweep_one_thread(torch, *args, 1),
                         2, warmup=1))
        return new, old

    path_new, path_old = in_turns(sets["path"])
    dense_new, dense_old = in_turns(sets["dense"])
    # edges read once (f32 distance, two int64 indices), one byte written
    # per edge; a few integer operations per edge
    b, by = bound_ms(e * 21, e * 4)
    src, rep = KERNEL_FILES["greedy_sweep"]
    return dict(
        name="greedy_sweep", route="cuda", source=src, replaces=rep,
        launches=counts["greedy_sweep"], max_abs_err=err,
        ms=path_new[0],
        plain_ms=timed(torch, lambda: gs.greedy_sweep_plain(d, c, t, n, 1),
                       1, warmup=0),
        bound_ms=b, bound_us=b * 1e3, bound_by=by, library_ms=None,
        shapes=dict(
            edges=e, n_rows=n, below_big=below, taken=taken,
            flags_differing=differ, ms_in_turns=path_new,
            one_thread_ms=path_old,
            wide_ms=timed(torch, lambda: gs.greedy_sweep(
                *sets["path_wide"], 1), 3, warmup=1),
            dense_ms=dense_new, dense_one_thread_ms=dense_old,
            wide_caliper=WIDE_CALIPER, tpu_kernel=False,
            note="ms and plain_ms are the path's edges (caliper "
                 f"{MAHALANOBIS_CALIPER}); wide_ms the same rows' edges "
                 f"at caliper {WIDE_CALIPER}; dense_ms those candidates "
                 "with every row treated; one_thread_ms the kernel this "
                 "one replaced, timed in turns with it; "
                 "below_big the edges each set has below BIG; "
                 "max_abs_err the largest |kernel - plain| over all four "
                 "sets' flags"))


def run_offline(torch, np, joined, true_sate):
    """The offline path on the card (launch counters set to 0 just before
    and read just after it), the same calls on the CPU, and the two new
    kernels against their plain versions. Prints the ``offline`` line and
    returns the two kernel rows, the offline ``segment_sums`` shapes and
    the path's launch counts."""
    from repro_torch.kernels import build
    build.reset_launches()
    g, g_clock = offline_relation(torch, joined)
    mg, m_clock = offline_matching(torch, joined, g["ps"], MATCH_ROWS)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    check_launches("offline", counts)
    t0 = time.perf_counter()
    cpu = joined.to("cpu")
    c, c_clock = offline_relation(torch, cpu, ps=g["ps"].cpu())
    U_s = mg["U"][:CPU_MATCH_ROWS].contiguous()
    mg_s, _ = offline_matching(torch, joined, g["ps"], CPU_MATCH_ROWS, U=U_s)
    mc_s, _ = offline_matching(torch, cpu, g["ps"].cpu(), CPU_MATCH_ROWS,
                               U=U_s.cpu())
    xg = sample_extras(torch, joined, U_s, CPU_MATCH_ROWS)
    xc = sample_extras(torch, cpu, U_s.cpu(), CPU_MATCH_ROWS)
    cpu_s = time.perf_counter() - t0
    y = joined[OFFLINE_Y]
    vs_cpu = compare_offline(torch, np, g, c, mg_s, mc_s, xg, xc,
                             y[:CPU_MATCH_ROWS],
                             cpu[OFFLINE_Y][:CPU_MATCH_ROWS])
    rows = joined.slice(0, MATCH_ROWS)
    c_valid = ~rows[OFFLINE_T].to(torch.bool) & rows.valid
    knn_row = knn_kernel_check(torch, mg["U"], c_valid, counts)
    wide = path_wide_nnmnr(torch, rows, mg["U"])
    sweep_row = sweep_kernel_check(torch, xg["nnmnr_wide"],
                                   mg["nnmnr_mahalanobis"], wide, counts)
    y_m = y[:MATCH_ROWS]
    methods = {name: dict(estimate_summary(g[f"{name}_est"]),
                          awmd={k: float(v) for k, v in
                                g[f"{name}_awmd"].items()})
               for name in ("cem", "em", "sub")}
    methods["nnmwr_ps"] = match_summary(torch, y, g["nnmwr_ps"])
    for name in ("nnmwr_mahalanobis", "nnmnr_mahalanobis", "nnmnr_ps"):
        methods[name] = dict(match_summary(torch, y_m, mg[name]),
                             rows=MATCH_ROWS)
    print(json.dumps({"offline": {
        "device": torch.cuda.get_device_name(0),
        "treatment": OFFLINE_T, "rows": joined.nrows,
        "match_rows": MATCH_ROWS, "methods": methods,
        "difference_in_means": float(g["dim"]),
        "raw_imbalance": {k: float(v) for k, v in g["raw"].items()},
        "true_sate": true_sate[OFFLINE_T],
        "propensity_model": host_model(g["model"]),
        "ms": dict(g_clock.ms, **m_clock.ms),
        "cpu_ms": c_clock.ms, "cpu_pass_s": cpu_s,
        "launches": counts, "cuda_vs_cpu": vs_cpu}}, default=lambda a: (
            a.tolist())))
    return ([knn_row, sweep_row],
            offline_segment_sums(torch, g["sub"], joined), counts)


def main() -> None:
    started = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import (CoarsenSpec, OnlineEngine,
                                  PartitionedOnlineEngine)
    from repro_torch.core.cem import make_codec
    from repro_torch.core.propensity import propensity_scores
    from repro_torch.data import flightgen
    from repro_torch.data.join import fk_join
    from repro_torch.kernels import build
    from repro_torch.kernels.ops import CutpointTable

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)

    # phase 2: build every kernel from the checkout's sources
    t0 = time.perf_counter()
    built = build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "built": built}))

    # phase 3: the main path
    t0 = time.perf_counter()
    data = flightgen.generate(n_flights=N_FLIGHTS, seed=0, device="cuda")
    joined = fk_join(data.flights, data.weather,
                     on={"airport": 64, "hour": 1 << 17}, prefix="w_")
    joined = joined.filter(joined["cancelled"] == 0)
    batches = [joined.slice(s, s + BATCH) for s in range(0, N_FLIGHTS, BATCH)]
    torch.cuda.synchronize()
    print(json.dumps({"data_s": time.perf_counter() - t0,
                      "rows": N_FLIGHTS, "batches": len(batches),
                      "invalid_rows": int((~joined.valid).sum())}))
    specs = build_specs(CoarsenSpec)
    shared = ["airport", "carrier", "traffic", "w_season"]
    treatments = {t: shared + c for t, c in COVARIATES.items()}

    build.reset_launches()
    gpu_eng, gpu_est, ingest_ms, query_ms, gpu_models, refresh_ms = \
        run_stream(torch, OnlineEngine, specs, treatments, batches, "cuda")
    stream_reads = gpu_eng.host_reads
    gpu_ps, gpu_full, scores_ms = run_scores(torch, propensity_scores,
                                             joined)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    check_launches("replicated", counts)
    t0 = time.perf_counter()
    cpu_eng, cpu_est, cpu_ingest_ms, _, cpu_models, _ = run_stream(
        torch, OnlineEngine, specs, treatments,
        [b.to("cpu") for b in batches], "cpu")
    cpu_ps, cpu_full, _ = run_scores(torch, propensity_scores,
                                     joined.to("cpu"))
    cpu_s = time.perf_counter() - t0
    summary = compare_runs(np, gpu_eng, cpu_eng, gpu_est, cpu_est)
    summary["model_max_rel"] = max(
        compare_models(np, label, mg, mc) for label, mg, mc in zip(
            ("cold refresh", "warm refresh"), gpu_models, cpu_models))
    summary["full_model_max_rel"] = compare_models(
        np, "propensity_scores", host_model(gpu_full), host_model(cpu_full))
    ps_g, ps_c = gpu_ps.cpu().numpy(), cpu_ps.numpy()
    if ps_g.shape != (N_FLIGHTS,) or not np.isfinite(ps_g).all():
        fail("propensity scores: not finite or of the wrong shape")
    summary["scores_max_abs_diff"] = float(np.abs(ps_g - ps_c).max())
    if summary["scores_max_abs_diff"] > RTOL_MODEL:
        fail(f"propensity scores differ by "
             f"{summary['scores_max_abs_diff']} (> {RTOL_MODEL})")
    final = {t: float(gpu_est[-1][(t, None)].ate) for t in COVARIATES}
    print(json.dumps({
        "main_path": {
            "device": torch.cuda.get_device_name(0),
            "ingests": len(ingest_ms), "queries": len(query_ms),
            "ingest_ms_median": statistics.median(ingest_ms),
            "ingest_ms_first": ingest_ms[0],
            "ingest_ms_retract": ingest_ms[-2],
            "ingest_ms_reingest": ingest_ms[-1],
            "query_ms_median": statistics.median(query_ms),
            "refresh_ms": {"cold": refresh_ms[0], "warm": refresh_ms[1]},
            "propensity_scores_ms": scores_ms,
            "models": {"cold": {k: v.tolist() for k, v in
                                gpu_models[0].items()},
                       "warm": {k: v.tolist() for k, v in
                                gpu_models[1].items()},
                       "full": {k: v.tolist() for k, v in
                                host_model(gpu_full).items()}},
            "ops_per_ingest": stream_op_counts(torch, gpu_eng, batches[3]),
            "host_reads": gpu_eng.host_reads,
            "cache_hits": gpu_eng.cache_hits,
            "cache_misses": gpu_eng.cache_misses,
            "launches": counts, "state": gpu_eng.stats(),
            "ate": final,
            "true_sate": {t: data.true_sate[t] for t in COVARIATES},
            "cpu_pass_s": cpu_s,
            "cpu_ingest_ms_median": statistics.median(cpu_ingest_ms),
            "cuda_vs_cpu": summary}}))

    # phase 3, partitioned: the same stream on the key-range partitioned
    # layout, held bit for bit against the replicated card run
    build.reset_launches()
    part_eng, part_est, p_ingest_ms, p_query_ms, part_models, p_refresh_ms = \
        run_stream(torch, PartitionedOnlineEngine, specs, treatments,
                   batches, "cuda", n_parts=N_PARTS)
    torch.cuda.synchronize()
    part_counts = build.launch_counts()
    part_reads = part_eng.host_reads
    check_launches("partitioned", part_counts)
    layouts = compare_layouts(torch, np,
                              (part_eng, part_est, part_models),
                              (gpu_eng, gpu_est, gpu_models), batches[5],
                              treatments)
    print(json.dumps({"partitioned": {
        "n_parts": N_PARTS,
        "ingests": len(p_ingest_ms), "queries": len(p_query_ms),
        "ingest_ms_median": statistics.median(p_ingest_ms),
        "ingest_ms_first": p_ingest_ms[0],
        "ingest_ms_retract": p_ingest_ms[-2],
        "ingest_ms_reingest": p_ingest_ms[-1],
        "query_ms_median": statistics.median(p_query_ms),
        "refresh_ms": {"cold": p_refresh_ms[0], "warm": p_refresh_ms[1]},
        "host_reads": {"partitioned": part_reads,
                       "replicated": stream_reads},
        "launches": part_counts, "state": part_eng.stats(),
        "vs_replicated": layouts}}))

    # phase 3, offline: the paper's Table 3 methods on the same relation
    offline_rows, offline_sums, offline_counts = run_offline(
        torch, np, joined, data.true_sate)

    # phase 4: every kernel against its plain version, timed
    kernels, pseudo = kernel_checks(torch, np, gpu_eng, batches[1], counts)
    kernels[1]["shapes"]["offline"] = offline_sums
    kernels.insert(3, parts_kernel_check(torch, part_eng, batches[0],
                                         part_counts))
    for row in kernels:
        if row["name"] == "chunk_sums":
            row["shapes"]["standardisation"] = chunk_sums_standardisation(
                torch, joined)
        if row["name"] == "cem_keys":
            # the offline cem() call's shape: the whole relation's Table 3
            # covariates
            row["shapes"]["offline"] = cem_keys_shape(
                torch, joined.columns, joined.valid, CutpointTable.for_codec(
                    make_codec(table3_specs(CoarsenSpec)),
                    table3_specs(CoarsenSpec), joined.device))
            row["launches_by_path"] = {
                "replicated": counts["cem_keys"],
                "partitioned": part_counts["cem_keys"],
                "offline": offline_counts["cem_keys"]}
    kernels.append(newton_checks(torch, gpu_eng, joined, gpu_full, counts))
    kernels += offline_rows
    # the same stream in turns on this card: replicated with and without
    # the reservoir (the reference's default and its reservoir_size=0
    # configuration) and partitioned, interleaved with the default:
    # ingest / query medians of each run
    turns = []
    for layout, size in (("replicated", 0), ("replicated", 8192),
                         ("partitioned", 8192), ("replicated", 8192),
                         ("partitioned", 8192), ("replicated", 0)):
        kw = dict(n_parts=N_PARTS) if layout == "partitioned" else {}
        _, _, t_ingest, t_query, _, _ = run_stream(
            torch, PartitionedOnlineEngine if kw else OnlineEngine, specs,
            treatments, batches, "cuda", reservoir_size=size, **kw)
        turns.append(dict(layout=layout, reservoir_size=size,
                          ingest_ms_median=statistics.median(t_ingest),
                          query_ms_median=statistics.median(t_query)))
    print(json.dumps({"propensity": propensity_repeats(torch, gpu_eng,
                                                       joined),
                      "turns": turns}))
    print(json.dumps({"segment_sums_pseudo_group": pseudo}))

    # phase 5: a steady-state window under the profiler, for each layout
    print(json.dumps({"profile": profile_window(
        torch, gpu_eng, batches[2], treatments)}))
    print(json.dumps({"profile_partitioned": profile_window(
        torch, part_eng, batches[2], treatments)}))

    # phase 6: results
    print(json.dumps({"total_s": time.perf_counter() - started}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
