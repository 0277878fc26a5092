"""Masked columnar batches on a torch device — the stand-in for a SQL row
set (counterpart of :mod:`repro.data.columnar`).

A ``Table`` is a dict of equal-length tensors plus a boolean validity
mask. WHERE clauses and inner-join misses are mask updates; invalid rows
are masked everywhere downstream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Table:
    """Masked columnar batch.

    columns: name -> tensor of shape (N,) or (N, d), all on one device.
    valid:   bool (N,); False rows are "deleted".
    """

    columns: Dict[str, torch.Tensor]
    valid: torch.Tensor

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_numpy(cls, cols: Mapping[str, np.ndarray], valid=None,
                   device: DeviceLike = None) -> "Table":
        """Copy host arrays onto ``device`` (``cuda`` unless named)."""
        dev = resolve_device(device)
        out = {k: torch.tensor(np.asarray(v), device=dev)
               for k, v in cols.items()}
        n = next(iter(out.values())).shape[0]
        for k, v in out.items():
            if v.shape[0] != n:
                raise ValueError(f"column {k}: length {v.shape[0]} != {n}")
        if valid is None:
            v = torch.ones((n,), dtype=torch.bool, device=dev)
        else:
            v = torch.tensor(np.asarray(valid, dtype=bool), device=dev)
        return cls(columns=out, valid=v)

    # -- basic accessors ---------------------------------------------------
    @property
    def nrows(self) -> int:
        return int(self.valid.shape[0])

    @property
    def device(self) -> torch.device:
        return self.valid.device

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def names(self) -> Iterator[str]:
        return iter(sorted(self.columns))

    def count(self) -> torch.Tensor:
        """Number of valid rows (a 0-d int64 tensor on the table's device)."""
        return self.valid.sum()

    # -- relational-ish ops ------------------------------------------------
    def filter(self, mask: torch.Tensor) -> "Table":
        """WHERE: rows failing ``mask`` become invalid. Shape unchanged."""
        return Table(self.columns, self.valid & mask.to(torch.bool))

    def with_columns(self, new: Mapping[str, torch.Tensor]) -> "Table":
        cols = dict(self.columns)
        cols.update(new)
        return Table(cols, self.valid)

    def select(self, names) -> "Table":
        return Table({n: self.columns[n] for n in names}, self.valid)

    def slice(self, start: int, stop: int) -> "Table":
        """Rows ``[start, stop)`` as views (no copy)."""
        return Table({k: v[start:stop] for k, v in self.columns.items()},
                     self.valid[start:stop])

    def to(self, device: DeviceLike) -> "Table":
        dev = torch.device(device)
        return Table({k: v.to(dev) for k, v in self.columns.items()},
                     self.valid.to(dev))

    # -- host-side utilities -----------------------------------------------
    def to_numpy(self, compact: bool = False) -> Dict[str, np.ndarray]:
        """Materialize on host. compact=True drops invalid rows."""
        out = {k: v.cpu().numpy() for k, v in self.columns.items()}
        v = self.valid.cpu().numpy()
        if compact:
            out = {k: a[v] for k, a in out.items()}
        else:
            out["_valid"] = v
        return out


def _round_capacity(n: int, granule: int = 4096) -> int:
    """Round row counts up to a granule (``columnar.py:129`` of the
    reference): the capacity rule of every materialized view."""
    return max(granule, ((n + granule - 1) // granule) * granule)
