"""The generated table: columns as the generators make them.

A generator returns a `Table`: every column as one tensor of the whole
table, on the device the generator ran on. A dictionary-encoded column holds
ids into `dictionary`, the sorted list of every value it may take (so id
order is value order); a raw column holds its values. A column with `scale`
is a decimal held as an integer count of 10**-scale (TPC-H's DECIMAL(15,2)
prices in cents): the program is handed it as DOUBLE, the reference computes
on the integers. A text column (`text`) holds each row's characters, one
byte each, NUL-padded to the column's width: every row has a value of its
own, so its dictionaries are made a segment at a time (`segments`).

`Table.sorted_by` puts the rows in the order of the configuration's sort
column (the time column an offline table's pushes are cut by), and
`Table.to_host` hands the arrays to numpy for the program's segments and the
reference; a text column stays on the device, since no query the reference
answers reads one.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Column:
    #: Pinot data type: INT, LONG, DOUBLE, STRING
    type: str
    #: schema role: dimension, metric or date_time
    role: str
    #: ids when `dictionary` is given, else the raw values
    data: object
    #: sorted values the ids index, or None for a raw column
    dictionary: np.ndarray | None = None
    #: a decimal's digits after the point: `data` holds value * 10**scale
    scale: int | None = None
    #: a text column: `data` is (rows, width) uint8 character codes
    text: bool = False


@dataclass
class Table:
    name: str
    columns: dict[str, Column] = field(default_factory=dict)

    @property
    def n_rows(self) -> int:
        return int(next(iter(self.columns.values())).data.shape[0])

    def sorted_by(self, column: str) -> "Table":
        """The rows in the order of `column` (stable)."""
        order = torch.sort(self.columns[column].data, stable=True).indices
        return Table(self.name, {n: dataclasses.replace(c, data=c.data[order]) for n, c in self.columns.items()})

    def to_host(self) -> "Table":
        """Every column as a numpy array; a dictionary column's ids in the
        narrowest integer type that holds them (so less crosses to the
        host)."""
        out = {}
        for n, c in self.columns.items():
            if c.text:
                continue
            data = c.data
            if c.dictionary is not None:
                card = len(c.dictionary)
                data = data.to(torch.uint8 if card <= 1 << 8 else torch.int16 if card <= 1 << 15 else torch.int32)
            out[n] = Column(c.type, c.role, data.cpu().numpy(), c.dictionary, c.scale)
        return Table(self.name, out)


def lookup_column(type_: str, role: str, lut: list, codes: torch.Tensor) -> Column:
    """A dictionary column whose row takes `lut[code]`: the dictionary is
    the sorted distinct values of `lut`, the ids index it."""
    values = sorted(set(lut))
    rank = {v: i for i, v in enumerate(values)}
    ids = torch.tensor([rank[v] for v in lut], dtype=torch.int32, device=codes.device)[codes.long()]
    dtype = np.int32 if type_ == "INT" else np.int64 if type_ == "LONG" else None
    return Column(type_, role, ids, np.array(values, dtype=dtype))


def text_pool(gen: torch.Generator, n_bytes: int, slots: list[tuple[list[str], float]]) -> torch.Tensor:
    """`n_bytes` of text (uint8 codes) made of sentences of `slots`: each
    slot a word list and the chance it is filled (None: filled where the
    slot before it is), its word drawn uniformly; the words of a sentence
    are joined by spaces, and a sentence ends with its last slot's word (a
    terminator) and a space."""
    device = gen.device
    vocab = [w for words, _ in slots for w in words]
    width = max(len(w) for w in vocab)
    codes = torch.zeros((len(vocab), width), dtype=torch.uint8)
    for i, w in enumerate(vocab):
        codes[i, : len(w)] = torch.tensor(list(w.encode("ascii")), dtype=torch.uint8)
    codes, lengths = codes.to(device), torch.tensor([len(w) for w in vocab], device=device)
    chances, last = [], 1.0
    for _, p in slots:
        last = last if p is None else p
        chances.append(last)
    mean_sentence = sum(p * (sum(map(len, words)) / len(words) + 1) for (words, _), p in zip(slots, chances))
    n_sentences = int(n_bytes / mean_sentence * 1.1) + 1
    first, tokens = 0, []
    for words, p in slots:
        word = first + torch.randint(len(words), (n_sentences,), generator=gen, device=device)
        if p is not None:
            keep = torch.rand(n_sentences, generator=gen, device=device) < p
        tokens.append(torch.where(keep, word, torch.full_like(word, -1)))
        first += len(words)
    tokens = torch.stack(tokens, 1)
    # a terminator follows its sentence's last word with no space between
    ends = torch.zeros_like(tokens, dtype=torch.bool)
    ends[:, -1] = True
    tokens, ends = tokens.reshape(-1), ends.reshape(-1)
    kept = tokens >= 0
    tokens = tokens[kept]
    before_end = torch.zeros_like(tokens, dtype=torch.bool)
    before_end[:-1] = ends[kept][1:]
    size = lengths[tokens] + (~before_end).long()
    starts = torch.cumsum(size, 0) - size
    pool = torch.full((int(starts[-1] + size[-1]),), 32, dtype=torch.uint8, device=device)
    for j in range(width):
        has = lengths[tokens] > j
        pool[starts[has] + j] = codes[tokens[has], j]
    if len(pool) < n_bytes:
        raise ValueError(f"the text pool came to {len(pool)} bytes, fewer than {n_bytes}")
    return pool[:n_bytes]


def text_column(gen: torch.Generator, pool: torch.Tensor, lo: int, hi: int, n: int) -> Column:
    """dbgen's text of `n` rows: each a substring of `pool` of a length drawn
    uniformly from [lo, hi] at an offset drawn uniformly."""
    length = uniform(gen, lo, hi, n)
    offset = uniform(gen, 0, len(pool) - hi, n)
    chars = pool.unfold(0, hi, 1)[offset]
    chars.masked_fill_(torch.arange(hi, device=pool.device) >= length[:, None], 0)
    return Column("STRING", "dimension", chars, text=True)


def raw_column(type_: str, role: str, values: torch.Tensor, scale: int | None = None) -> Column:
    dtype = {"INT": torch.int32, "LONG": torch.int64}.get(type_, torch.int64)
    return Column(type_, role, values.to(dtype), None, scale)


def days(start: str, end: str) -> list[_dt.date]:
    """Every date from `start` to `end`, both included (ISO dates)."""
    d0, d1 = _dt.date.fromisoformat(start), _dt.date.fromisoformat(end)
    return [d0 + _dt.timedelta(n) for n in range((d1 - d0).days + 1)]


def uniform(gen: torch.Generator, lo: int, hi: int, n: int) -> torch.Tensor:
    """n integers drawn uniformly from [lo, hi], int64."""
    return torch.randint(lo, hi + 1, (n,), generator=gen, device=gen.device, dtype=torch.int64)


def order_lines(gen: torch.Generator, n_orders: int, max_lines: int, n_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """dbgen's orders of 1..max_lines lines, cut to exactly `n_rows` lines
    (the last orders dropped, the last one kept in part). Each count
    from 1 to max_lines is given to every max_lines-th order, and the counts
    are dealt in a seeded order: every seed makes the same number of lines
    and the same multiset of order sizes, where dbgen's independent draws
    would move the table's size with the seed. Returns (each line's order
    index, each line's number within its order, from 1)."""
    lines = (torch.arange(n_orders, device=gen.device) % max_lines + 1)[
        torch.randperm(n_orders, generator=gen, device=gen.device)
    ]
    ends = torch.cumsum(lines, 0)
    if int(ends[-1]) < n_rows:
        raise ValueError(f"{n_orders} orders make {int(ends[-1])} lines, fewer than {n_rows}")
    order = torch.repeat_interleave(torch.arange(n_orders, device=lines.device), lines)[:n_rows]
    starts = ends - lines
    number = torch.arange(n_rows, device=lines.device) - starts[order] + 1
    return order, number


def sparse_order_key(order: torch.Tensor) -> torch.Tensor:
    """dbgen's order keys: 8 keys used of every 32."""
    return (order // 8) * 32 + order % 8 + 1


def retail_cents(partkey: torch.Tensor) -> torch.Tensor:
    """dbgen's P_RETAILPRICE of a part key, in cents."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
