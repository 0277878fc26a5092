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

from repro_torch.kernels.cem_keys import cem_keys

if TYPE_CHECKING:     # importing repro_torch.core imports this module
    from repro_torch.core.coarsen import CoarsenSpec
    from repro_torch.core.keys import KeyCodec


@dataclasses.dataclass(frozen=True)
class CutpointTable:
    """The fused coarsen + pack kernel's side inputs for one codec, built
    once per engine and kept on its device: (d, C) f32 cutpoints padded
    with +inf, real-cutpoint counts and bit widths, in codec field order."""

    names: Tuple[str, ...]
    cutpoints: torch.Tensor
    n_cuts: torch.Tensor
    widths: torch.Tensor

    @staticmethod
    def build(lists: Sequence[Sequence[float]], widths: Sequence[int],
              names: Sequence[str], device) -> "CutpointTable":
        cmax = max([1] + [len(c) for c in lists])
        cp = torch.full((len(lists), cmax), float("inf"), dtype=torch.float32)
        for j, c in enumerate(lists):
            cp[j, :len(c)] = torch.tensor(c, dtype=torch.float32)
        return CutpointTable(
            names=tuple(names), cutpoints=cp.to(device),
            n_cuts=torch.tensor([len(c) for c in lists],
                                dtype=torch.int32).to(device),
            widths=torch.tensor(list(widths), dtype=torch.int32).to(device))

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
    """Coarsen + pack a batch's named columns through the kernel."""
    X = torch.stack([columns[n].to(torch.float32) for n in table.names],
                    dim=1)
    return cem_keys(X, table.cutpoints, table.n_cuts, table.widths,
                    valid.to(torch.bool).contiguous())
