"""Side inputs of the coarsen + pack kernel — the part of
:mod:`repro.kernels.ops` the port needs: the padded cutpoint table built
once per engine, and the call that feeds a batch's named columns through
the kernel. The kernel wrappers themselves (and their plain versions)
live in :mod:`repro_torch.kernels.cem_keys` and
:mod:`repro_torch.kernels.segment_stats`.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Mapping, Sequence, Tuple

import torch

from repro_torch.kernels import cem_keys as ck

if TYPE_CHECKING:     # importing repro_torch.core imports this module
    from repro_torch.core.coarsen import CoarsenSpec
    from repro_torch.core.keys import KeyCodec


@dataclasses.dataclass(frozen=True)
class CutpointTable:
    """The fused coarsen + pack kernel's side inputs for one codec, built
    once per engine: the (d, C) f32 cutpoints padded with +inf, on its
    device; and on the host the real-cutpoint counts, the bit widths and
    the launch's per-codec part (:func:`repro_torch.kernels.cem_keys.fields`),
    in codec field order."""

    names: Tuple[str, ...]
    cutpoints: torch.Tensor
    n_cuts: Tuple[int, ...]
    widths: Tuple[int, ...]
    fields: bytes

    @staticmethod
    def build(lists: Sequence[Sequence[float]], widths: Sequence[int],
              names: Sequence[str], device) -> "CutpointTable":
        cmax = max([1] + [len(c) for c in lists])
        cp = torch.full((len(lists), cmax), float("inf"), dtype=torch.float32)
        for j, c in enumerate(lists):
            cp[j, :len(c)] = torch.tensor(c, dtype=torch.float32)
        n_cuts = tuple(len(c) for c in lists)
        widths = tuple(int(w) for w in widths)
        return CutpointTable(
            names=tuple(names), cutpoints=cp.to(device), n_cuts=n_cuts,
            widths=widths, fields=ck.fields(n_cuts, widths))

    @staticmethod
    def for_codec(codec: KeyCodec, specs: Mapping[str, CoarsenSpec],
                  device) -> "CutpointTable":
        """Columns in codec field order (sorted by name); categorical specs
        as cutpoints ``1..card-1`` (:meth:`CoarsenSpec.kernel_cutpoints`)."""
        return CutpointTable.build(
            [specs[n].kernel_cutpoints() for n in codec.names],
            [codec.widths[n] for n in codec.names], codec.names, device)


def cem_keys_columns(columns: Mapping[str, torch.Tensor], valid: torch.Tensor,
                     table: CutpointTable
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarsen + pack a batch's named columns (any dtype the kernel reads,
    any stride): on CUDA one launch of the kernel, which reads them where
    they lie; on the CPU its plain version over the stacked f32 columns."""
    return ck.cem_keys_cols([columns[n] for n in table.names], valid,
                            table.cutpoints, table.n_cuts, table.widths,
                            table.fields)
