"""Package boundary of the port: ``repro_torch`` and ``chip_smoke.py``
import torch and numpy only — never ``jax`` and nothing of the reference
package ``repro`` (not even its numpy-only modules) — and every module
imports on its own (no import cycle). Checked in a fresh interpreter, so
this test process's own imports cannot hide a leak."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:                    # each one first, as a user may
    for m in [m for m in sys.modules if m.startswith("repro_torch.")]:
        del sys.modules[m]
    importlib.import_module(name)
import chip_smoke                     # its top-level import graph
# what chip_smoke.main() imports once it has found a card
from repro_torch.core import CoarsenSpec, OnlineEngine, PartitionedOnlineEngine
from repro_torch.core.cube import partition_ids, route_delta, unpartition_view
from repro_torch.core.groupby import lookup_rows_in_parts
from repro_torch.kernels.segment_stats import scatter_merge_parts
from repro_torch.data import flightgen
from repro_torch.data.join import fk_join
from repro_torch.kernels import build
# the offline path's modules, as chip_smoke.run_offline imports them
from repro_torch.core import (awmd, cem, difference_in_means, estimate_ate,
                              exact_matching, features, mahalanobis_transform,
                              nnmnr, nnmwr, nnmwr_att, ps_distance_features,
                              raw_imbalance, subclassify)
from repro_torch.kernels.knn_topk import knn_topk, knn_topk_plain
from repro_torch.kernels.greedy_sweep import greedy_sweep, greedy_sweep_plain
for mod in ("matching", "distance", "balance", "subclassification", "cem",
            "ate"):
    assert "repro_torch.core." + mod in names, mod
for mod in ("knn_topk", "greedy_sweep"):
    assert "repro_torch.kernels." + mod in names, mod
leaks = sorted(m for m in sys.modules
               if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
               or m == "repro" or m.startswith("repro."))
print(len(names), leaks)
assert not leaks, leaks
assert len(names) >= 21, names
"""


def test_port_imports_neither_jax_nor_the_reference_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c",
         SCRIPT.format(src=str(ROOT / "src"), root=str(ROOT))],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    assert out.stdout.strip().endswith("[]")
