"""Foreign-key joins for normalized schemas (paper §4.1) — counterpart of
:mod:`repro.data.join`.

FLIGHTDELAY is a fact table (flights) pointing at a dimension table
(weather) via (airport, hour): pack the join keys on both sides, sort the
dimension side once, binary-search each fact key, gather. The output has
the fact table's rows; facts without a dimension row become invalid.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from repro_torch.core.groupby import lookup_rows_in_table
from repro_torch.core.keys import KeyCodec, sort_key
from repro_torch.data.columnar import Table


def pack_join_keys(table: Table, on: Mapping[str, int], codec: KeyCodec = None
                   ) -> Tuple[KeyCodec, torch.Tensor, torch.Tensor]:
    """Pack integer join columns (name -> cardinality) into sortable keys."""
    codec = codec or KeyCodec.from_cardinalities(on)
    buckets = {n: table[n].to(torch.int64) for n in codec.names}
    hi, lo = codec.pack(buckets, table.valid)
    return codec, hi, lo


def fk_join(fact: Table, dim: Table, on: Mapping[str, int],
            prefix: str = "") -> Table:
    """fact LEFT-INNER join dim on shared integer key columns.

    Facts whose key is missing (or whose dim row is invalid) become
    invalid — the masked analogue of an inner join. Dim columns are
    appended (optionally prefixed); shared key columns are not duplicated.
    """
    codec, fhi, flo = pack_join_keys(fact, on)
    _, dhi, dlo = pack_join_keys(dim, on, codec)
    _, perm = torch.sort(sort_key(dhi, dlo), stable=True)
    pos, found = lookup_rows_in_table(fhi, flo, dhi[perm], dlo[perm])
    src = perm[pos]

    new_cols: Dict[str, torch.Tensor] = dict(fact.columns)
    for name in dim.names():
        if name in on:
            continue
        out_name = prefix + name
        if out_name in new_cols:
            raise ValueError(f"join column collision: {out_name}")
        new_cols[out_name] = dim.columns[name][src]
    valid = fact.valid & found & dim.valid[src]
    return Table(new_cols, valid)
