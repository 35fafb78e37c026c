"""Cut a generated table into the program's segments.

The rows, already in the order of the configuration's sort column (a
dictionary column of dates), are cut into `n_segments` spans of equal
length in time: the sort column's dictionary, every date the generator can
make, cut into equal runs of ids. An offline table's batch pushes arrive so,
cut by time, and the cut dates are the same for every seed, so every seed
makes segments of the same date ranges and nearly the same sizes (a cut by
row count moves with the seed, and where it falls on a date the data gives
a meaning, as TPC-H's 1995-06-17, it changes the segments' dictionaries and
the work). Each segment goes to the port through `segment_from_numpy`: its
dictionaries are the values that segment holds and its ids index them; its
stats (cardinality, min, max, sortedness) are worked out here from the
generated arrays, on the device they were made on. No string is sorted on
the host: a text column's dictionary of each segment is sorted on the device,
its characters compared as big-endian 8-byte words.
"""

from __future__ import annotations

import numpy as np
import torch

from olap_bench.table import Table


def bounds(host: Table, n_segments: int, sort_column: str) -> list[tuple[int, int]]:
    """[start, end) rows of each segment of `host` (the table on the host,
    sorted by `sort_column`)."""
    col = host.columns[sort_column]
    if col.dictionary is None:
        raise ValueError(f"segments are cut by the dates of a dictionary column; {sort_column} has none")
    card = len(col.dictionary)
    edges = np.searchsorted(col.data, [card * k // n_segments for k in range(n_segments + 1)], "left")
    edges[-1] = len(col.data)
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]


def _plain(v):
    return v.item() if isinstance(v, np.generic) else v


def text_dictionary(chars: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(each row's id, the sorted distinct values as a fixed-width unicode
    array) of a text column's rows: `chars` (rows, width) uint8 codes below
    128, NUL-padded. Ids follow the values' order."""
    n, width = chars.shape
    device = chars.device
    words = -(-width // 8)
    padded = torch.zeros((n, words * 8), dtype=torch.uint8, device=device)
    padded[:, :width] = chars
    # 8 codes a word, the first the highest byte: words compare as the text does
    shifts = torch.arange(56, -8, -8, device=device, dtype=torch.int64)
    keys = (padded.view(n, words, 8).to(torch.int64) << shifts).sum(-1)
    order = torch.arange(n, device=device)
    for k in reversed(range(words)):
        order = order[torch.sort(keys[order, k], stable=True).indices]
    ranked = keys[order]
    first = torch.ones(n, dtype=torch.bool, device=device)
    first[1:] = (ranked[1:] != ranked[:-1]).any(1)
    ids = torch.empty(n, dtype=torch.int32, device=device)
    ids[order] = (torch.cumsum(first, 0) - 1).to(torch.int32)
    values = chars[order[first]].to(torch.int32).cpu().numpy().view(f"<U{width}").reshape(-1)
    return ids.cpu().numpy(), values


def _schema_json(table: Table) -> str:
    from pinot_tpu_torch.common.types import DataType, Schema

    roles: dict[str, list] = {"dimension": [], "metric": [], "date_time": []}
    for name, col in table.columns.items():
        roles[col.role].append((name, DataType(col.type)))
    return Schema.build(
        table.name, dimensions=roles["dimension"], metrics=roles["metric"], date_times=roles["date_time"]
    ).to_json()


def descriptions(table: Table, host: Table, cuts: list[tuple[int, int]]) -> list[dict]:
    """`segment_from_numpy` descriptions of the segments of `table` (its
    columns on any device) at `cuts` (`bounds`); the arrays in them are
    numpy, a raw column's taken from `host` (`table.to_host()`)."""
    schema = _schema_json(table)
    n_segments = len(cuts)
    seg_of_row = torch.repeat_interleave(
        torch.arange(n_segments, device=next(iter(table.columns.values())).data.device),
        torch.tensor([e - s for s, e in cuts], device=next(iter(table.columns.values())).data.device),
    )
    descs = [
        {"name": f"{table.name}_{i}", "schema": schema, "n_docs": e - s, "columns": {}} for i, (s, e) in enumerate(cuts)
    ]
    for name, col in table.columns.items():
        data = col.data
        if col.text:
            for i, (s, e) in enumerate(cuts):
                fwd, values = text_dictionary(data[s:e])
                stats = {"cardinality": len(values), "min": str(values[0]), "max": str(values[-1]), "column": name}
                stats.update({"dataType": col.type, "sorted": bool((fwd[1:] >= fwd[:-1]).all()), "totalDocs": e - s})
                descs[i]["columns"][name] = {"forward": fwd, "dictionary": values, "stats": stats}
            continue
        if col.dictionary is not None:
            card = len(col.dictionary)
            present = torch.bincount(seg_of_row * card + data.long(), minlength=n_segments * card)
            present = present.view(n_segments, card) > 0
            # a segment's id of each table-wide id: its rank among the ids
            # that segment holds
            remap = (torch.cumsum(present.int(), 1) - 1).to(torch.int32)
            seg_ids = remap.view(-1)[seg_of_row * card + data.long()]
            present_host = present.cpu().numpy()
            ids_host = seg_ids.cpu().numpy()
        else:
            ids_host = host.columns[name].data
            if col.scale is not None:
                ids_host = ids_host.astype(np.float64) / 10**col.scale
        for i, (s, e) in enumerate(cuts):
            fwd = ids_host[s:e]
            part = data[s:e]
            is_sorted = bool((part[1:] >= part[:-1]).all()) if e - s > 1 else True
            if col.dictionary is not None:
                values = col.dictionary[present_host[i]]
                stats = {"cardinality": len(values), "min": _plain(values[0]), "max": _plain(values[-1])}
                dictionary = values
            else:
                stats = {"cardinality": int(torch.unique(part).numel()), "min": _plain(fwd.min()), "max": _plain(fwd.max())}
                dictionary = None
            stats.update({"column": name, "dataType": col.type, "sorted": is_sorted, "totalDocs": e - s})
            descs[i]["columns"][name] = {"forward": fwd, "dictionary": dictionary, "stats": stats}
    return descs


def build(table: Table, n_segments: int, sort_column: str) -> list:
    """The program's segments of `table` (sorted by `sort_column`)."""
    from pinot_tpu_torch.segment.convert import segment_from_numpy

    host = table.to_host()
    return [segment_from_numpy(d) for d in descriptions(table, host, bounds(host, n_segments, sort_column))]
