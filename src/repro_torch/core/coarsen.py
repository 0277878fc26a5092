"""Covariate coarsening (the "C" of CEM) — counterpart of
:mod:`repro.core.coarsen`.

:class:`CoarsenSpec` is a copy of the reference's class with the SAME
class name and fields: ``OnlineEngine.schema_fingerprint`` is the ``repr``
of the specs, and a snapshot exported by the reference engine installs
into the port only when the two fingerprints match.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CoarsenSpec:
    """How to coarsen one covariate.

    kind: "cutpoints" (continuous; buckets = len(cutpoints)+1)
          or "categorical" (values already in [0, cardinality)).
    """

    kind: str
    cutpoints: Optional[tuple] = None   # static tuple of floats, sorted
    cardinality: Optional[int] = None

    @property
    def n_buckets(self) -> int:
        if self.kind == "categorical":
            return int(self.cardinality)
        return len(self.cutpoints) + 1

    @staticmethod
    def categorical(cardinality: int) -> "CoarsenSpec":
        return CoarsenSpec(kind="categorical", cardinality=int(cardinality))

    @staticmethod
    def from_cutpoints(cutpoints: Sequence[float]) -> "CoarsenSpec":
        cp = tuple(float(c) for c in cutpoints)
        if list(cp) != sorted(cp):
            raise ValueError("cutpoints must be sorted")
        return CoarsenSpec(kind="cutpoints", cutpoints=cp)

    @staticmethod
    def equal_width(lo: float, hi: float, k: int) -> "CoarsenSpec":
        """k buckets of equal width over [lo, hi] (paper's §5.2 choice)."""
        if k < 1:
            raise ValueError("k >= 1")
        edges = np.linspace(lo, hi, k + 1)[1:-1]
        return CoarsenSpec.from_cutpoints(edges.tolist())

    def kernel_cutpoints(self) -> tuple:
        """The cutpoints the fused coarsen + pack kernel compares against.

        A categorical spec goes through as the cutpoints ``1..card-1``:
        the bucket is then the count of those ``<= x``, which equals
        ``clip(int(x), 0, card-1)`` (:func:`coarsen`) for every finite
        ``x`` in ``[0, card)`` — the only values ``validate_batch`` lets
        through on valid rows."""
        if self.kind == "categorical":
            return tuple(float(c) for c in range(1, int(self.cardinality)))
        return self.cutpoints


def coarsen(x: torch.Tensor, spec: CoarsenSpec) -> torch.Tensor:
    """Map values to int64 bucket ids in [0, spec.n_buckets)."""
    if spec.kind == "categorical":
        return torch.clamp(x.to(torch.int32), 0,
                           spec.cardinality - 1).to(torch.int64)
    cp = torch.tensor(spec.cutpoints, dtype=torch.float32, device=x.device)
    return torch.searchsorted(cp, x.to(torch.float32).contiguous(),
                              right=True)


def coarsen_columns(columns: Mapping[str, torch.Tensor],
                    specs: Mapping[str, CoarsenSpec]
                    ) -> Dict[str, torch.Tensor]:
    """Coarsen every spec'd column; returns {name: bucket ids}."""
    return {name: coarsen(columns[name], spec) for name, spec in specs.items()}
